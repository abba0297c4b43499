"""Plain PyTorch reference of the SE(2) constrained neural-field planner.

It follows the published method (NFOMP: an occupancy field trained online on
samples along the path, and a constrained trajectory optimization that reads
it) as the configuration file states it, with the random stream the port
draws: every step takes uniforms [B, (N-1) + (K+N-1) + 3R], normals
[B, 2, N-1, 3] and uniforms [B, N-1, S] from one `torch.Generator`, in that
order. Given the same generator state and the same state, it computes what
the program should; it imports nothing of the program, no kernel and no
capture, and differentiates with autograd.

A state is a dict of tensors, each with a leading problem axis B:
trajectory [B, N, 3], params (the field: encoding, mlp1, mlp2, out,
angle_biases), fopt / topt (Adam: count [B], mu, nu), cmult [B, N+1]
(non-holonomic multipliers), kmult [B, N] (collision multipliers), buf
[B, K, 3], ages [B, K], prev [B, N, 3], start, goal [B, 3], bounds [B, 4],
count [B].

`precision` is "float32" (every product in f32, TF32 off) or "tf32" (both
operands of every product rounded to TF32's 10-bit mantissa and summed in
f32): the second is the control that the comparison must refuse.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

PAD = 1e9  # the coordinate of a padded obstacle point


# ------------------------------------------------------------------ helpers

def tree_map(fn, tree, *rest):
    if torch.is_tensor(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest)) for k in tree}
    return tree


def tree_leaves(tree):
    if torch.is_tensor(tree):
        return [tree]
    return [leaf for k in tree for leaf in tree_leaves(tree[k])]


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (1 sign, 8 exponent, 10 mantissa bits), to nearest
    even, kept in float32."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    rounded = (bits + 0xFFF + lsb) & ~0x1FFF
    return rounded.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b on batched operands as TF32 computes it, and its backward the
    same way: both operands of each product rounded, sums in f32."""

    @staticmethod
    def forward(ctx, a, b):
        ar, br = to_tf32(a), to_tf32(b)
        ctx.save_for_backward(ar, br)
        return torch.matmul(ar, br)

    @staticmethod
    def backward(ctx, g):
        ar, br = ctx.saved_tensors
        gr = to_tf32(g)
        return torch.matmul(gr, br.transpose(-1, -2)), torch.matmul(ar.transpose(-1, -2), gr)


def matmul(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "tf32":
        if a.ndim != b.ndim:
            return torch.matmul(to_tf32(a), to_tf32(b))  # no gradient is taken there
        return _TF32MatMul.apply(a, b)
    if precision != "float32":
        raise ValueError(f"unknown precision {precision!r}")
    return torch.matmul(a, b)


def wrap_angle(a):
    return torch.remainder(a + math.pi, 2.0 * math.pi) - math.pi


def linspace(start, stop, num: int):
    """[B] -> [B, num]: start (1 - s) + stop s, s = i / (num - 1) divided on
    the host, the last point exact."""
    s = (torch.arange(num - 1, dtype=torch.float32) / (num - 1)).to(start.device)
    out = start[..., None] * (1 - s) + stop[..., None] * s
    return torch.cat([out, stop[..., None]], dim=-1)


def uniform_box(u, bounds):
    """Uniform draws [B, R, 3] -> poses in the boxes [B, 4], angle in [0, 2pi)."""
    b = bounds[:, None, :]
    x = b[..., 0] + u[..., 0] * (b[..., 1] - b[..., 0])
    y = b[..., 2] + u[..., 1] * (b[..., 3] - b[..., 2])
    return torch.stack([x, y, u[..., 2] * 2.0 * math.pi], dim=-1)


# -------------------------------------------------------------- the world

def rectangle_collision(world: dict, poses: torch.Tensor) -> torch.Tensor:
    """[B, M, 3] poses -> [B, M] bool: an obstacle point strictly inside the
    footprint box in the robot's frame, or the pose outside the world box."""
    px, py, th = poses[..., 0], poses[..., 1], poses[..., 2]
    c, s = torch.cos(th)[..., None], torch.sin(th)[..., None]
    ox = world["points"][:, None, :, 0] - px[..., None]
    oy = world["points"][:, None, :, 1] - py[..., None]
    lx = c * ox + s * oy
    ly = -s * ox + c * oy
    box = world["box"][:, None, None, :]
    inside = ((lx > box[..., 0]) & (lx < box[..., 1]) & (ly > box[..., 2]) & (ly < box[..., 3])
              & world["mask"][:, None, :])
    b = world["bounds"][:, None, :]
    outside = (px > b[..., 1]) | (px < b[..., 0]) | (py > b[..., 3]) | (py < b[..., 2])
    return torch.any(inside, dim=-1) | outside


def dense_path(full: torch.Tensor, samples: int) -> torch.Tensor:
    """[B, M, 3] -> [B, (M-1) S + 1, 3]: xy lerp and shortest-arc angle."""
    a, b = full[:, :-1], full[:, 1:]
    f = torch.arange(samples, dtype=full.dtype, device=full.device) / samples
    d = b - a
    d = torch.cat([d[..., :2], wrap_angle(d[..., 2:])], dim=-1)
    dense = (a[:, :, None, :] + f[None, None, :, None] * d[:, :, None, :]).reshape(
        full.shape[0], -1, 3)
    return torch.cat([dense, full[:, -1:]], dim=1)


def collides(world: dict, full: torch.Tensor, samples: int = 5) -> torch.Tensor:
    """[B] bool: any of `samples` poses per segment of paths [B, M, 3] collides."""
    return torch.any(rectangle_collision(world, dense_path(full, samples)), dim=1)


# -------------------------------------------------------------- the field

def init_field(g: torch.Generator, onf: dict, rows: int) -> dict:
    """`rows` fields drawn as torch.nn.Linear's init, the encoding's weight
    then redrawn from a normal, and the angle phases uniform in [-pi, pi)."""
    fourier, hidden = onf["fourier_features"], onf["hidden"]
    feature = fourier + 2 * onf["angle_harmonics"]

    def uniform(shape, bound):
        u = torch.rand(shape, generator=g, device=g.device)
        return -bound + u * (bound - -bound)

    def linear(fan_in, fan_out):
        bound = 1.0 / math.sqrt(float(fan_in))
        return {"w": uniform((rows, fan_in, fan_out), bound), "b": uniform((rows, fan_out), bound)}

    params = {"encoding": linear(2, fourier)}
    params["encoding"]["w"] = torch.randn((rows, 2, fourier), generator=g, device=g.device)
    params["mlp1"] = linear(feature, hidden)
    params["mlp2"] = linear(hidden, hidden)
    params["out"] = linear(hidden + feature, 1)
    u = torch.rand((rows, 2 * onf["angle_harmonics"]), generator=g, device=g.device)
    params["angle_biases"] = -math.pi + u * (math.pi - -math.pi)
    return params


def field(params: dict, x: torch.Tensor, onf: dict, precision: str) -> torch.Tensor:
    """[B, M, 3] poses -> [B, M] logits: Fourier features of xy (sin | cos),
    learned-phase angle harmonics of theta, two ReLU layers, and an output
    that also reads the features (a skip connection)."""
    fourier, harmonics, hid = onf["fourier_features"], onf["angle_harmonics"], onf["hidden"]
    xy = (x[..., :2] - onf["mean"]) / onf["sigma"]
    enc = matmul(xy, params["encoding"]["w"], precision) + params["encoding"]["b"][:, None, :]
    enc = torch.cat([torch.sin(enc[..., :fourier // 2]), torch.cos(enc[..., fourier // 2:])], -1)
    freqs = torch.arange(1, harmonics + 1, dtype=x.dtype, device=x.device)
    phase = (x[..., 2][..., None] + params["angle_biases"][:, None, :]) * torch.cat([freqs, freqs])
    angle = torch.cat([torch.sin(phase[..., :harmonics]), torch.cos(phase[..., harmonics:])], -1)
    features = torch.cat([enc, angle], dim=-1)
    h = torch.relu(matmul(features, params["mlp1"]["w"], precision)
                   + params["mlp1"]["b"][:, None, :])
    h = torch.relu(matmul(h, params["mlp2"]["w"], precision) + params["mlp2"]["b"][:, None, :])
    w3 = params["out"]["w"]
    out = (matmul(h, w3[:, :hid], precision) + matmul(features, w3[:, hid:], precision)
           + params["out"]["b"][:, None, :])
    return out[..., 0]


def bce(logits, targets):
    """Mean BCE-with-logits per problem."""
    loss = torch.clamp(logits, min=0.0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))
    return loss.mean(dim=1)


def field_grads(params, points, truth, onf, precision):
    with torch.enable_grad():
        leaves = tree_map(lambda p: p.detach().requires_grad_(True), params)
        loss = bce(field(leaves, points, onf, precision), truth.float())
        flat = tree_leaves(leaves)
        grads = torch.autograd.grad(loss.sum(), flat)
    it = iter(grads)
    return loss.detach(), tree_map(lambda _: next(it), leaves)


# ------------------------------------------------------------------ Adam

def adam_init(params, rows: int, device):
    return {"count": torch.zeros((rows,), dtype=torch.int32, device=device),
            "mu": tree_map(torch.zeros_like, params), "nu": tree_map(torch.zeros_like, params)}


def adam(grads, opt, params, lr, b1, b2, eps):
    count = opt["count"] + 1
    steps = count.to(torch.float32)
    bc1 = 1 - torch.pow(torch.tensor(b1, device=steps.device), steps)
    bc2 = 1 - torch.pow(torch.tensor(b2, device=steps.device), steps)
    mu = tree_map(lambda g, m: (1 - b1) * g + b1 * m, grads, opt["mu"])
    nu = tree_map(lambda g, v: (1 - b2) * (g * g) + b2 * v, grads, opt["nu"])

    def step(p, m, v):
        shape = (-1,) + (1,) * (p.ndim - 1)
        return p + (-lr) * ((m / bc1.reshape(shape)) / (torch.sqrt(v / bc2.reshape(shape)) + eps))

    return tree_map(step, params, mu, nu), {"count": count, "mu": mu, "nu": nu}


# ------------------------------------------------------------ the planner

class Planner:
    """The method at one configuration (`cfg`: the configuration file's
    "solver" dict), in `precision`, on `device`."""

    def __init__(self, cfg: dict, device, precision: str = "float32"):
        self.cfg = cfg
        self.onf = cfg["onf"]
        self.device = torch.device(device)
        self.precision = precision
        n, w = cfg["trajectory_length"], cfg["velocity_hessian_weight"]
        h = torch.zeros((n, n), dtype=torch.float64)
        idx = torch.arange(n)
        h[idx, idx] = 4.0
        h[idx[1:], idx[:-1]] = -2.0
        h[idx[:-1], idx[1:]] = -2.0
        self.inv_hessian = torch.linalg.inv(w * h + torch.eye(n, dtype=torch.float64)).float().to(
            self.device)

    # ---------------------------------------------------------------- init

    def initial_trajectory(self, start, goal):
        m = self.cfg["trajectory_length"] + 2
        x = linspace(start[:, 0], goal[:, 0], m)[:, 1:-1]
        y = linspace(start[:, 1], goal[:, 1], m)[:, 1:-1]
        th = linspace(start[:, 2], start[:, 2] + wrap_angle(goal[:, 2] - start[:, 2]), m)[:, 1:-1]
        return torch.stack([x, y, th], dim=-1)

    def init_state(self, g, start, goal, bounds, world, group_size: int = 1) -> dict:
        """Fresh problems: the field drawn once per group of `group_size`
        consecutive problems, then the replay buffer's uniform fill, then
        `init_collision_iteration` pretraining steps on uniform points."""
        cfg = self.cfg
        batch, n, k = start.shape[0], cfg["trajectory_length"], cfg["collision_point_count"]
        traj = self.initial_trajectory(start, goal)
        groups = batch // group_size
        rows = torch.arange(batch, device=self.device) // group_size
        params = tree_map(lambda x: x[rows], init_field(g, self.onf, groups))
        u = torch.rand((batch, k, 3), generator=g, device=g.device)
        state = {
            "trajectory": traj, "params": params, "fopt": adam_init(params, batch, self.device),
            "topt": adam_init(traj, batch, self.device),
            "cmult": torch.zeros((batch, n + 1), device=self.device),
            "kmult": torch.zeros((batch, n), device=self.device),
            "buf": uniform_box(u, bounds), "ages": torch.zeros((batch, k), device=self.device),
            "prev": traj, "start": start, "goal": goal, "bounds": bounds,
            "count": torch.zeros((batch,), dtype=torch.int32, device=self.device),
        }
        if cfg["init_collision_iteration"]:
            state = self.pretrain(state, g, world, group_size)
        return state

    def pretrain(self, state, g, world, group_size):
        cfg = self.cfg
        batch = state["start"].shape[0]
        firsts = torch.arange(0, batch, group_size, device=self.device)
        pick = lambda x: x[firsts]  # noqa: E731
        params, opt = tree_map(pick, state["params"]), tree_map(pick, state["fopt"])
        bounds, sub_world = state["bounds"][firsts], tree_map(pick, world)
        for _ in range(cfg["init_collision_iteration"]):
            u = torch.rand((firsts.numel(), cfg["init_collision_points"], 3), generator=g,
                           device=g.device)
            points = uniform_box(u, bounds)
            _, grads = field_grads(params, points, rectangle_collision(sub_world, points),
                                   self.onf, self.precision)
            params, opt = self.field_adam(grads, opt, params)
        rows = torch.arange(batch, device=self.device) // group_size
        return {**state, "params": tree_map(lambda x: x[rows], params),
                "fopt": tree_map(lambda x: x[rows], opt)}

    def field_adam(self, grads, opt, params):
        b1, b2 = self.cfg["collision_betas"]
        return adam(grads, opt, params, self.cfg["collision_lr"], b1, b2, self.cfg["adam_eps"])

    # ---------------------------------------------------------------- step

    def field_update(self, s, g, world, group_size):
        """Sample along the previous path, resample the replay buffer by
        Gumbel top-k over the field's scores, label with the world, and take
        one Adam step on the mean BCE (the group's mean gradient when fields
        are shared)."""
        cfg = self.cfg
        prev, bounds = s["prev"], s["bounds"]
        batch, n, _ = prev.shape
        k, r = cfg["collision_point_count"], cfg["random_field_points"]
        cand = k + n - 1
        u = torch.rand((batch, (n - 1) + cand + 3 * r), generator=g, device=g.device)
        t = u[:, : n - 1, None]
        gumbel = -torch.log(-torch.log(torch.clamp(u[:, n - 1: n - 1 + cand], min=1e-20) + 1e-20))
        random_points = uniform_box(u[:, n - 1 + cand:].reshape(batch, r, 3), bounds)
        positions = prev[:, 1:] * (1.0 - t) + prev[:, :-1] * t
        normal = torch.randn((batch, 2, n - 1, 3), generator=g, device=g.device)
        coarse = positions + normal[:, 0] * torch.tensor(
            [cfg["course_random_offset"]] * 2 + [cfg["angle_offset"]], device=self.device)
        fine = positions + normal[:, 1] * torch.tensor(
            [cfg["trajectory_random_offset"]] * 2 + [cfg["angle_offset"]], device=self.device)
        candidates = torch.cat([s["buf"], fine], dim=1)
        ages = torch.cat([s["ages"], torch.zeros_like(fine[..., 0])], dim=1)
        logits = field(s["params"], candidates, self.onf, self.precision)
        log_w = F.logsigmoid(logits) - ages * cfg["buffer_age_decay"]
        floor = float(torch.log(torch.tensor(cfg["buffer_weight_floor"], dtype=torch.float32)))
        log_w = torch.logaddexp(log_w, torch.tensor(floor, device=self.device))
        idx = torch.topk(log_w + gumbel, k, dim=-1).indices
        buf = torch.gather(candidates, 1, idx[..., None].expand(-1, -1, 3))
        new_ages = torch.gather(ages, 1, idx) + 1.0
        points = torch.cat([coarse, buf, random_points], dim=1)
        loss, grads = field_grads(s["params"], points, rectangle_collision(world, points),
                                  self.onf, self.precision)
        if group_size > 1:
            def mean(x):
                grouped = x.reshape((batch // group_size, group_size) + tuple(x.shape[1:]))
                return grouped.mean(dim=1, keepdim=True).expand(grouped.shape).reshape(x.shape)
            grads = tree_map(mean, grads)
        params, fopt = self.field_adam(grads, s["fopt"], s["params"])
        return {**s, "params": params, "fopt": fopt, "buf": buf, "ages": new_ages,
                "prev": s["trajectory"]}, loss

    def trajectory_loss(self, traj, cmult, kmult, s, t):
        cfg, onf = self.cfg, self.onf
        batch = traj.shape[0]
        full = torch.cat([s["start"][:, None], traj, s["goal"][:, None]], dim=1)
        samples = t.shape[-1]
        delta = traj[:, :-1] - traj[:, 1:]
        delta = torch.cat([delta[..., :2], wrap_angle(delta[..., 2:])], dim=-1)
        poses = (traj[:, 1:, None, :] + t[..., None] * delta[:, :, None, :]).reshape(batch, -1, 3)
        mult = (kmult[:, 1:, None] * (1.0 - t) + kmult[:, :-1, None] * t).reshape(batch, -1)
        z = field(s["params"], poses, onf, self.precision)
        beta = cfg["collision_beta"]
        scaled = beta * z
        linear = scaled > 20.0
        soft = torch.log1p(torch.exp(torch.where(linear, torch.zeros_like(scaled), scaled))) / beta
        collision = torch.where(linear, z, soft).sum(dim=1) / samples
        multiplier = (mult * torch.tanh(z)).sum(dim=1) / samples
        # non-holonomic slip and backward motion per segment
        dx = full[:, 1:, 0] - full[:, :-1, 0]
        dy = full[:, 1:, 1] - full[:, :-1, 1]
        ang = full[..., 2]
        mid = ang[:, :-1] + wrap_angle(ang[:, 1:] - ang[:, :-1]) / 2.0
        slip = dx * torch.sin(mid) - dy * torch.cos(mid)
        mid_back = ang[:, :-1] + wrap_angle(ang[:, :-1] - ang[:, 1:]) / 2.0
        backward = torch.clamp(-(torch.cos(mid_back) * dx + torch.sin(mid_back) * dy), min=0.0)
        # CHOMP distance with the angle-sum closure
        d = full[:, 1:] - full[:, :-1]
        closure = (torch.sum(wrap_angle(d[..., 2]), dim=-1).detach() - full[:, -1, 2]
                   + full[:, 0, 2])
        raw = d[..., 2]
        corrected = torch.cat([raw[:, :-1], (raw[:, -1] + closure)[:, None]], 1) * cfg["angle_weight"]
        d = torch.cat([d[..., :2], corrected[..., None]], dim=-1)
        distance = torch.sum(d * d, dim=(1, 2))
        b = s["bounds"][:, :, None]
        x, y = traj[..., 0], traj[..., 1]
        boundary = torch.sum(torch.clamp(b[:, 0] - x, min=0.0) ** 2 + torch.clamp(x - b[:, 1], min=0.0) ** 2
                             + torch.clamp(b[:, 2] - y, min=0.0) ** 2
                             + torch.clamp(y - b[:, 3], min=0.0) ** 2, dim=-1)
        return (distance + collision * cfg["collision_weight"]
                + torch.sum(cmult * slip, dim=1)
                + torch.sum(slip ** 2, dim=1) * cfg["constraint_deltas_weight"]
                + boundary * cfg["boundary_weight"] + multiplier
                + cfg["direction_delta_weight"] * torch.sum(backward ** 2, dim=1))

    def trajectory_update(self, s, g):
        """H^-1-preconditioned Adam on the waypoints, dual ascent on both
        multiplier vectors (the collision ones kept >= 0)."""
        cfg = self.cfg
        batch, n = s["trajectory"].shape[:2]
        t = torch.rand((batch, n - 1, cfg["collision_samples_per_segment"]), generator=g,
                       device=g.device)
        with torch.enable_grad():
            leaves = [s[key].detach().requires_grad_(True)
                      for key in ("trajectory", "cmult", "kmult")]
            loss = self.trajectory_loss(*leaves, s, t)
            tg, cg, kg = torch.autograd.grad(loss.sum(), leaves)
        tg = matmul(self.inv_hessian, tg, self.precision)
        b1, b2 = cfg["trajectory_betas"]
        traj, topt = adam({"t": tg}, {"count": s["topt"]["count"], "mu": {"t": s["topt"]["mu"]},
                                      "nu": {"t": s["topt"]["nu"]}},
                          {"t": s["trajectory"]}, cfg["trajectory_lr"], b1, b2, cfg["adam_eps"])
        return {**s, "trajectory": traj["t"],
                "topt": {"count": topt["count"], "mu": topt["mu"]["t"], "nu": topt["nu"]["t"]},
                "cmult": s["cmult"] + cfg["multipliers_lr"] * cg,
                "kmult": torch.clamp(s["kmult"] + cfg["collision_multipliers_lr"] * kg, min=0.0)}

    def reparametrize(self, s):
        """Waypoints and both multiplier vectors resampled uniformly in xy arc
        length."""
        full = torch.cat([s["start"][:, None], s["trajectory"], s["goal"][:, None]], dim=1)
        m = full.shape[1]
        seg = torch.sqrt(torch.sum((full[:, 1:, :2] - full[:, :-1, :2]) ** 2, dim=-1))
        total = torch.clamp(seg.sum(dim=-1, keepdim=True), min=1e-12)
        cdf = torch.cat([torch.zeros_like(seg[:, :1]), torch.cumsum(seg / total, dim=-1)], dim=-1)
        uniform = (torch.arange(m - 1, dtype=cdf.dtype, device=cdf.device) / (m - 1))[1:]
        above = torch.clamp(torch.sum(cdf[:, None, :] < uniform[None, :, None], dim=-1), max=m - 1)
        below = torch.clamp(above - 1, min=0)
        lo, hi = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
        den = hi - lo
        den = torch.where(den < 1e-5, torch.full_like(den, 1e-5), den)
        t = torch.clamp((uniform - lo) / den, 0.0, 1.0)

        def rows(v, i):
            return torch.gather(v, 1, i[..., None].expand(-1, -1, v.shape[-1]))

        def lerp(v):
            return (1.0 - t) * torch.gather(v, 1, below) + t * torch.gather(v, 1, above)

        fb, fa = rows(full, below), rows(full, above)
        xy = (1.0 - t[..., None]) * fb[..., :2] + t[..., None] * fa[..., :2]
        th = fb[..., 2] + t * wrap_angle(fa[..., 2] - fb[..., 2])
        zero = torch.zeros_like(s["kmult"][:, :1])
        c = s["cmult"]
        nodes = torch.cat([c[:, :1], 0.5 * (c[:, :-1] + c[:, 1:]), c[:, -1:]], dim=1)
        v = lerp(nodes)
        return {**s, "trajectory": torch.cat([xy, th[..., None]], dim=-1),
                "kmult": lerp(torch.cat([zero, s["kmult"], zero], dim=1)),
                "cmult": torch.cat([v[:, :1], 0.5 * (v[:, :-1] + v[:, 1:]), v[:, -1:]], dim=1)}

    def step(self, s, g, world, group_size: int = 1):
        s, _ = self.field_update(s, g, world, group_size)
        s = self.trajectory_update(s, g)
        due = s["count"] % self.cfg["reparametrize_trajectory_freq"] == 0
        r = self.reparametrize(s)
        for key in ("trajectory", "kmult", "cmult"):
            s[key] = torch.where(due.reshape((-1,) + (1,) * (r[key].ndim - 1)), r[key], s[key])
        s["count"] = s["count"] + 1
        return s

    def run(self, s, g, world, steps: int, group_size: int = 1):
        for _ in range(steps):
            s = self.step(s, g, world, group_size)
        return s

    # -------------------------------------------------------- live updates

    def update_start(self, s, start):
        """Move the starts: waypoints up to the one nearest the new start
        collapse onto it; then reparametrize and restart the schedule."""
        n = s["trajectory"].shape[1]
        dist = torch.sum((s["trajectory"][..., :2] - start[:, None, :2]) ** 2, dim=-1)
        first = torch.clamp(torch.argmin(dist, dim=1) + 1, max=n)
        head = (torch.arange(n, device=self.device)[None, :] < first[:, None])[..., None]
        s = {**s, "trajectory": torch.where(head, start[:, None, :], s["trajectory"]),
             "start": start, "count": torch.zeros_like(s["count"])}
        return self.reparametrize(s)

    def retarget(self, s, start, goal):
        """New queries on the same maps: fresh path, multipliers and path
        optimizer; the field, its optimizer and the buffer stay."""
        batch, n = start.shape[0], self.cfg["trajectory_length"]
        traj = self.initial_trajectory(start, goal)
        return {**s, "trajectory": traj, "topt": adam_init(traj, batch, self.device),
                "cmult": torch.zeros((batch, n + 1), device=self.device),
                "kmult": torch.zeros((batch, n), device=self.device), "prev": traj,
                "start": start, "goal": goal,
                "count": torch.zeros((batch,), dtype=torch.int32, device=self.device)}

    @staticmethod
    def full_path(s) -> torch.Tensor:
        return torch.cat([s["start"][:, None], s["trajectory"], s["goal"][:, None]], dim=1)
