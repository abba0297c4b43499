// Native path-quality metrics evaluator.
//
// The port's own copy of nfopp_tpu/bench/native/path_stats.cpp: the
// counterpart of the reference's only native component, the bench-mr/OMPL
// PathStatistics evaluation behind
// benchmark/bench_mr_binding/BenchmarkAdapter.cpp:68-135 (path length,
// max/normalized curvature, AOL, smoothness, clearing distances, cusps).
// Host code, not a device kernel. Exposed as a plain C ABI consumed from
// Python via ctypes (nfopp_tpu_torch/bench/native_binding.py, which builds
// it at first use); a numpy twin lives in nfopp_tpu_torch/bench/metrics.py
// and is cross-checked against this library in tests.
//
// Formulas:
//   path_length    = sum |p[i+1]-p[i]| (xy)
//   curvature      = Menger curvature of consecutive point triples:
//                    k_i = 2*|cross(b-a, c-b)| / (|b-a|*|c-b|*|c-a|)
//   max_curvature  = max_i k_i
//   normalized_curvature = sum_i k_i * ds_i   (curvature integrated over arc
//                    length, ds_i = half the span |c-a| around the triple)
//   aol            = sum |wrap(heading delta)| / path_length (angle-over-length)
//   smoothness     = OMPL PathGeometric::smoothness(): for consecutive segment
//                    lengths a, b and chord c: angle = pi - acos((a^2+b^2-c^2)/2ab),
//                    smoothness += (2*angle/(a+b))^2, with the SE(2) state
//                    distance d = sqrt(dx^2+dy^2) + w_theta*|wrap(dtheta)|
//   cusps          = count of triples whose tangent-direction change exceeds
//                    a threshold (BenchmarkAdapter.cpp computeCusps:
//                    |wrap(yaw_next - yaw_prev)| > cusp_angle_threshold),
//                    skipping duplicate points
//   clearing       = per-waypoint min distance to obstacle points (mean,
//                    median, min, max)
#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

constexpr double kPi = 3.14159265358979323846;

double wrap_angle(double a) {
    a = std::fmod(a + kPi, 2.0 * kPi);
    if (a < 0) a += 2.0 * kPi;
    return a - kPi;
}

struct XY {
    double x, y;
};

double dist(const XY& a, const XY& b) {
    return std::hypot(b.x - a.x, b.y - a.y);
}

}  // namespace

extern "C" {

// path: [n][3] row-major (x, y, theta). Results written to out[12]:
//  0: path_length, 1: max_curvature, 2: normalized_curvature, 3: aol,
//  4: smoothness, 5: cusp_count, 6: mean_clearing, 7: median_clearing,
//  8: min_clearing, 9: max_clearing, 10: heading_change_sum, 11: reserved.
// obstacles: [m][2] or null (clearing stats become -1).
void nfopp_path_stats(const double* path, int64_t n, const double* obstacles,
                      int64_t m, double angular_weight, double cusp_threshold,
                      double* out) {
    for (int i = 0; i < 12; ++i) out[i] = 0.0;
    if (n < 2) {
        out[6] = out[7] = out[8] = out[9] = -1.0;
        return;
    }
    std::vector<XY> pts(n);
    for (int64_t i = 0; i < n; ++i) pts[i] = {path[3 * i], path[3 * i + 1]};

    // path length
    double length = 0.0;
    for (int64_t i = 0; i + 1 < n; ++i) length += dist(pts[i], pts[i + 1]);
    out[0] = length;

    // Menger curvature over triples
    double max_k = 0.0, norm_k = 0.0;
    for (int64_t i = 0; i + 2 < n; ++i) {
        const XY& a = pts[i];
        const XY& b = pts[i + 1];
        const XY& c = pts[i + 2];
        const double ab = dist(a, b), bc = dist(b, c), ca = dist(a, c);
        if (ab < 1e-12 || bc < 1e-12 || ca < 1e-12) continue;
        const double cross =
            std::fabs((b.x - a.x) * (c.y - b.y) - (b.y - a.y) * (c.x - b.x));
        const double k = 2.0 * cross / (ab * bc * ca);
        max_k = std::max(max_k, k);
        norm_k += k * 0.5 * ca;
    }
    out[1] = max_k;
    out[2] = norm_k;

    // AOL: accumulated tangent-heading change / length
    double heading_sum = 0.0;
    double prev_heading = std::atan2(pts[1].y - pts[0].y, pts[1].x - pts[0].x);
    for (int64_t i = 1; i + 1 < n; ++i) {
        if (dist(pts[i], pts[i + 1]) < 1e-12) continue;
        const double h =
            std::atan2(pts[i + 1].y - pts[i].y, pts[i + 1].x - pts[i].x);
        heading_sum += std::fabs(wrap_angle(h - prev_heading));
        prev_heading = h;
    }
    out[10] = heading_sum;
    out[3] = length > 1e-12 ? heading_sum / length : 0.0;

    // OMPL smoothness with SE(2) compound distance
    auto se2_dist = [&](int64_t i, int64_t j) {
        const double d = dist(pts[i], pts[j]);
        const double dt =
            std::fabs(wrap_angle(path[3 * j + 2] - path[3 * i + 2]));
        return d + angular_weight * dt;
    };
    double smooth = 0.0;
    if (n > 2) {
        double a = se2_dist(0, 1);
        for (int64_t i = 2; i < n; ++i) {
            const double b = se2_dist(i - 1, i);
            const double c = se2_dist(i - 2, i);
            if (a > 1e-12 && b > 1e-12) {
                const double acos_val = (a * a + b * b - c * c) / (2.0 * a * b);
                if (acos_val > -1.0 && acos_val < 1.0) {
                    const double angle = kPi - std::acos(acos_val);
                    const double k = 2.0 * angle / (a + b);
                    smooth += k * k;
                }
            }
            a = b;
        }
    }
    out[4] = smooth;

    // cusps (duplicate-skipping tangent flips, BenchmarkAdapter.cpp:104-133)
    int64_t cusps = 0;
    {
        int64_t prev = 0, cur = 0, next = 0;
        while (next < n) {
            if (dist(pts[prev], pts[cur]) <= 0.0) {
                ++cur;
                ++next;
            } else if (next < n && dist(pts[cur], pts[next]) <= 0.0) {
                ++next;
            } else if (next < n) {
                const double yaw_prev =
                    std::atan2(pts[cur].y - pts[prev].y, pts[cur].x - pts[prev].x);
                const double yaw_next =
                    std::atan2(pts[next].y - pts[cur].y, pts[next].x - pts[cur].x);
                if (std::fabs(wrap_angle(yaw_next - yaw_prev)) > cusp_threshold)
                    ++cusps;
                prev = cur;
                cur = next;
                ++next;
            }
        }
    }
    out[5] = static_cast<double>(cusps);

    // clearing distances vs obstacle points
    if (obstacles != nullptr && m > 0) {
        std::vector<double> clearing(n);
        for (int64_t i = 0; i < n; ++i) {
            double best = 1e300;
            for (int64_t j = 0; j < m; ++j) {
                const double dx = pts[i].x - obstacles[2 * j];
                const double dy = pts[i].y - obstacles[2 * j + 1];
                best = std::min(best, dx * dx + dy * dy);
            }
            clearing[i] = std::sqrt(best);
        }
        double sum = 0.0;
        for (double c : clearing) sum += c;
        out[6] = sum / static_cast<double>(n);
        std::vector<double> sorted = clearing;
        std::sort(sorted.begin(), sorted.end());
        out[7] = (n % 2 == 1)
                     ? sorted[n / 2]
                     : 0.5 * (sorted[n / 2 - 1] + sorted[n / 2]);
        out[8] = sorted.front();
        out[9] = sorted.back();
    } else {
        out[6] = out[7] = out[8] = out[9] = -1.0;
    }
}

// EXACT clearance vs polygon edges (the reference's clearance is measured
// against the true polygon environment, BenchmarkAdapter.cpp:106-135 — not a
// rasterization). segments: [s][4] rows (x0, y0, x1, y1). Writes
// out[4] = mean, median, min, max of the per-waypoint min distance to any
// segment. s == 0 writes -1s.
void nfopp_path_clearance_segments(const double* path, int64_t n,
                                   const double* segments, int64_t s,
                                   double* out) {
    if (n < 1 || segments == nullptr || s < 1) {
        out[0] = out[1] = out[2] = out[3] = -1.0;
        return;
    }
    std::vector<double> clearing(n);
    for (int64_t i = 0; i < n; ++i) {
        const double px = path[3 * i], py = path[3 * i + 1];
        double best = 1e300;
        for (int64_t j = 0; j < s; ++j) {
            const double x0 = segments[4 * j], y0 = segments[4 * j + 1];
            const double dx = segments[4 * j + 2] - x0;
            const double dy = segments[4 * j + 3] - y0;
            const double denom = dx * dx + dy * dy;
            double t = denom > 1e-30 ? ((px - x0) * dx + (py - y0) * dy) / denom
                                     : 0.0;
            t = std::max(0.0, std::min(1.0, t));
            const double cx = x0 + t * dx - px;
            const double cy = y0 + t * dy - py;
            best = std::min(best, cx * cx + cy * cy);
        }
        clearing[i] = std::sqrt(best);
    }
    double sum = 0.0;
    for (double c : clearing) sum += c;
    out[0] = sum / static_cast<double>(n);
    std::vector<double> sorted = clearing;
    std::sort(sorted.begin(), sorted.end());
    out[1] = (n % 2 == 1) ? sorted[n / 2]
                          : 0.5 * (sorted[n / 2 - 1] + sorted[n / 2]);
    out[2] = sorted.front();
    out[3] = sorted.back();
}

// Batched evaluation: paths [batch][n][3] -> out [batch][12].
void nfopp_path_stats_batch(const double* paths, int64_t batch, int64_t n,
                            const double* obstacles, int64_t m,
                            double angular_weight, double cusp_threshold,
                            double* out) {
    for (int64_t b = 0; b < batch; ++b) {
        nfopp_path_stats(paths + b * n * 3, n, obstacles, m, angular_weight,
                         cusp_threshold, out + b * 12);
    }
}

}  // extern "C"
