"""The plain reference at tiny sizes against cases worked out by hand."""
import math

import numpy as np
import pytest
import torch

from nfbench.harness import core

ref = core.reference_module("planner_se2")
post = core.reference_module("postprocess")


def test_tf32_rounding():
    x = torch.tensor([1.0 + 2 ** -11, 1.0 + 3 * 2 ** -12, 1.0 + 2 ** -10, -3.0 - 2 ** -12])
    assert ref.to_tf32(x).tolist() == [1.0, 1.0 + 2 ** -10, 1.0 + 2 ** -10, -3.0]


def test_tf32_product_and_its_gradient():
    a = torch.tensor([[[1.0 + 2 ** -12, 2.0]]], requires_grad=True)
    b = torch.tensor([[[3.0], [1.0 + 2 ** -12]]], requires_grad=True)
    out = ref.matmul(a, b, "tf32")
    assert out.item() == 5.0  # both 1 + 2^-12 round to 1
    out.sum().backward()
    assert a.grad.tolist() == [[[3.0, 1.0]]] and b.grad.tolist() == [[[1.0], [2.0]]]


def test_rectangle_footprint():
    world = {"points": torch.tensor([[[0.1, 0.0], [0.25, 0.0], [0.25, 0.25]]]),
             "mask": torch.tensor([[True, True, True]]),
             "box": torch.tensor([[-0.3, 0.2, -0.3, 0.2]]),
             "bounds": torch.tensor([[-1.0, 1.0, -1.0, 1.0]])}
    one = {k: v[:, :1] if k in ("points", "mask") else v for k, v in world.items()}
    poses = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 0.0, math.pi / 2], [2.0, 0.0, 0.0]]])
    # (0.1, 0): local (0.1, 0) at heading 0, (0, -0.1) at pi/2, both in the box;
    # a pose outside the world box always collides
    assert ref.rectangle_collision(one, poses).tolist() == [[True, True, True]]
    two = {k: v[:, 1:2] if k in ("points", "mask") else v for k, v in world.items()}
    # (0.25, 0): local x 0.25 > 0.2 at heading 0; local (0, -0.25) at pi/2
    assert ref.rectangle_collision(two, poses).tolist() == [[False, True, True]]
    three = {k: v[:, 2:] if k in ("points", "mask") else v for k, v in world.items()}
    # (0.25, 0.25): local x 0.25 at heading 0; local (-0.25, -0.25) at heading pi
    behind = torch.tensor([[[0.0, 0.0, 0.0], [0.0, 0.0, math.pi]]])
    assert ref.rectangle_collision(three, behind).tolist() == [[False, True]]


def test_field_by_hand():
    onf = {"mean": 0.0, "sigma": 2.0, "fourier_features": 2, "angle_harmonics": 1, "hidden": 1}
    params = {"encoding": {"w": torch.tensor([[[1.0], [0.5]]]), "b": torch.tensor([[0.25]])},
              "angle_biases": torch.tensor([[0.0, 0.5]]),
              "mlp1": {"w": torch.tensor([[[1.0], [-1.0], [0.5], [2.0]]]),
                       "b": torch.tensor([[0.1]])},
              "mlp2": {"w": torch.tensor([[[3.0]]]), "b": torch.tensor([[-0.2]])},
              "out": {"w": torch.tensor([[[2.0], [1.0], [1.0], [1.0], [1.0]]]),
                      "b": torch.tensor([[0.3]])}}
    params["encoding"]["w"] = torch.tensor([[[1.0, 0.0], [0.5, 1.0]]])
    params["encoding"]["b"] = torch.tensor([[0.25, -0.5]])
    x = torch.tensor([[[1.0, 2.0, 0.3]]])
    got = ref.field(params, x, onf, "float32").item()
    e = np.array([0.5 * 1.0 + 1.0 * 0.5 + 0.25, 0.5 * 0.0 + 1.0 * 1.0 - 0.5])
    feats = np.array([np.sin(e[0]), np.cos(e[1]), np.sin(0.3 + 0.0), np.cos(0.3 + 0.5)])
    h1 = max(0.0, feats @ np.array([1.0, -1.0, 0.5, 2.0]) + 0.1)
    h2 = max(0.0, 3.0 * h1 - 0.2)
    want = 2.0 * h2 + feats.sum() + 0.3
    assert got == pytest.approx(want, rel=1e-6)


def test_adam_first_step_moves_by_the_rate():
    params = {"p": torch.tensor([[1.0, -2.0]])}
    opt = ref.adam_init(params, 1, "cpu")
    new, opt = ref.adam({"p": torch.tensor([[0.5, -4.0]])}, opt, params, 0.1, 0.9, 0.9, 1e-8)
    assert new["p"][0].tolist() == pytest.approx([0.9, -1.9], rel=1e-6)
    assert opt["count"].tolist() == [1]


def test_reparametrize_spaces_waypoints_evenly():
    cfg = core.load_json("configs", "car-se2")["solver"] | {"trajectory_length": 3}
    planner = ref.Planner(cfg, "cpu")
    s = {"start": torch.tensor([[0.0, 0.0, 0.0]]), "goal": torch.tensor([[4.0, 0.0, 0.0]]),
         "trajectory": torch.tensor([[[0.5, 0.0, 0.0], [1.0, 0.0, 0.0], [3.5, 0.0, 0.0]]]),
         "kmult": torch.tensor([[1.0, 2.0, 3.0]]), "cmult": torch.zeros((1, 4))}
    out = planner.reparametrize(s)
    assert out["trajectory"][0, :, 0].tolist() == pytest.approx([1.0, 2.0, 3.0], abs=1e-6)
    # collision multipliers at x = 1, 2, 3 on the nodes 0, 0.5, 1, 3.5, 4 carrying 0, 1, 2, 3, 0
    assert out["kmult"][0].tolist() == pytest.approx([2.0, 2.4, 2.8], abs=1e-5)


def test_straight_path_collides_nowhere_and_endpoints_count():
    world = {"points": torch.tensor([[[5.0, 5.0]]]), "mask": torch.tensor([[True]]),
             "box": torch.tensor([[-0.3, 0.2, -0.3, 0.2]]),
             "bounds": torch.tensor([[0.0, 3.0, 0.0, 3.0]])}
    path = torch.tensor([[[0.5, 1.0, 0.0], [1.5, 1.0, 0.0], [2.5, 1.0, 0.0]],
                         [[0.5, 1.0, 0.0], [1.5, 1.0, 0.0], [3.5, 1.0, 0.0]]])
    assert ref.collides(world, path, 5).tolist() == [False, True]


def test_postprocess_of_a_straight_line():
    path = np.stack([np.linspace(0.0, 1.0, 11), np.zeros(11), np.zeros(11)], axis=1)
    out = post.postprocess(path)
    # 20 points at 1/19 spacing; the first is dropped (the flip index starts at 1)
    assert out.shape == (19, 3)
    assert out[:, 0] == pytest.approx(np.linspace(0.0, 1.0, 20)[1:], abs=1e-5)
    assert np.abs(out[:, 1:]).max() < 1e-12
