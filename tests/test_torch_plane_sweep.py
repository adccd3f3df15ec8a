"""Which path ``CostVolume`` takes, and what it counts, on the CPU.

The fused plane sweep (``csrc/plane_sweep.cu`` through
``ops/plane_sweep.py``) runs only on the card, where ``chip_smoke.py``'s
``[plane_sweep]`` holds it against the plane-chunk loop.  Here: the
kernel's predicate (``CostVolume.kernel_takes``) is false whenever a
gradient could flow, for ``cosine``, for a bfloat16 head, for widths the
kernel was not built for; CPU tensors always take the loop, which counts
its samples as ``plane_sweep_samples`` with ``path="plain"`` and launches
nothing; and the head's packed layout, as the kernel reads it, gives the
head's own output.
"""
import numpy as np
import pytest
import torch

from freesplat_tpu_torch.models.cost_volume import CostVolume
from freesplat_tpu_torch.models.encoder import sweep_geometry
from freesplat_tpu_torch.ops import plane_sweep as PS
from freesplat_tpu_torch.utils.profiling import Recorder, recording


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the tier-1 run shares the cores among workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def sweep_inputs(b=2, s=1, h=6, w=8, c=48, seed=0):
    """CostVolume's inputs for ``b`` views posed side by side, each swept
    against ``s`` of the others."""
    rng = np.random.default_rng(seed)
    v = b
    extr = np.tile(np.eye(4, dtype=np.float32), (v, 1, 1))
    extr[:, 0, 3] = 0.1 * np.arange(v)
    intr = np.tile(np.array([[0.9, 0, 0.5], [0, 1.2, 0.5], [0, 0, 1]], np.float32), (v, 1, 1))
    _, src_T_cur, src_K, cur_invK = sweep_geometry(
        torch.from_numpy(extr), torch.from_numpy(intr), s + 1, (h, w))
    feats = torch.from_numpy(rng.standard_normal((b, h, w, c)).astype(np.float32))
    src = torch.from_numpy(rng.standard_normal((b, s, h, w, c)).astype(np.float32))
    return (feats, src, src_T_cur, src_K, cur_invK, torch.full((b,), 0.5),
            torch.full((b,), 15.0))


def test_kernel_takes_serving_calls():
    cv = CostVolume(48, num_depth_bins=8)
    args = sweep_inputs()
    with torch.no_grad():
        assert cv.kernel_takes(*args)
    # Gradients on, but nothing asks for one.
    cv.requires_grad_(False)
    assert cv.kernel_takes(*args)


def _requires_grad(i):
    def make(args):
        args = list(args)
        args[i] = args[i].clone().requires_grad_(True)
        return args
    return make


@pytest.mark.parametrize("case", [
    "head_param", "cur_feats", "src_feats", "src_T_cur", "src_K", "cur_invK", "min_depth",
    "max_depth", "cosine", "bfloat16_head", "float64_head", "width_40", "float64_inputs",
    "bfloat16_features", "other_head_widths", "too_many_sources",
])
def test_kernel_takes_nothing_else(case):
    """Each case breaks one condition of a serving call the kernel takes."""
    c, s = 48, 1
    kw: dict = {}
    names = ["cur_feats", "src_feats", "src_T_cur", "src_K", "cur_invK", "min_depth",
             "max_depth"]
    if case == "width_40":
        c = 40
    elif case == "too_many_sources":
        s = PS.MAX_SOURCES + 1
    elif case == "cosine":
        kw["similarity"] = "cosine"
    elif case == "bfloat16_head":
        kw["dtype"] = torch.bfloat16
    elif case == "other_head_widths":
        kw["mlp_channels"] = (16, 1)
    cv = CostVolume(c, num_depth_bins=8, **kw).requires_grad_(case == "head_param")
    if case == "float64_head":
        cv.mlp.double()
    args = sweep_inputs(b=s + 1, s=s, c=c)
    if case in names:
        args = _requires_grad(names.index(case))(args)
    elif case == "float64_inputs":
        args = [a.double() for a in args]
    elif case == "bfloat16_features":
        args = [args[0].bfloat16(), args[1].bfloat16(), *args[2:]]
    assert not cv.kernel_takes(*args)
    if case in names or case == "head_param":
        with torch.no_grad():  # no gradient can flow: the kernel's again
            assert cv.kernel_takes(*args)


def test_cpu_calls_take_the_loop_and_count_their_samples():
    b, s, h, w, d = 3, 2, 6, 8, 8
    cv = CostVolume(48, num_depth_bins=d).eval()
    args = sweep_inputs(b=b, s=s, h=h, w=w)
    before = dict(PS.launch_count)
    rec = Recorder(events=False)
    with torch.no_grad():
        assert cv.kernel_takes(*args)
        plain = cv(*args)
        with recording(rec):
            got = cv(*args)
    assert torch.equal(got, plain) and got.shape == (b, h, w, d) and got.dtype == torch.float32
    tree = rec.flush()
    assert [(c["name"], c["value"], c["attrs"]) for c in tree["counters"]] == [
        ("plane_sweep_samples", b * s * d * h * w, {"path": "plain"})]
    # Under autograd too, once a call, and the kernel never launches here.
    rec = Recorder(events=False)
    with recording(rec):
        cv(*args).sum().backward()
    assert [(c["value"], c["attrs"]["path"]) for c in rec.flush()["counters"]] == [
        (b * s * d * h * w, "plain")]
    assert PS.launch_count == before
    with pytest.raises(RuntimeError, match="CUDA kernel"):
        PS.plane_sweep(args[0], args[1], torch.zeros(b, d), torch.zeros(b, h * w, 3),
                       torch.zeros(b, s, 3, 4), PS.pack_head(cv.mlp))


def test_packed_head_layout_gives_the_head():
    """``pack_head`` read as the kernel reads it: W1^T (c + 1, 32), b1,
    W2^T (32, 32), b2, w3 (32), b3."""
    c = 48
    torch.manual_seed(3)
    cv = CostVolume(c, num_depth_bins=8).eval()
    head = PS.pack_head(cv.mlp).numpy().astype(np.float64)
    k = c + 1
    sizes = [k * 32, 32, 32 * 32, 32, 32, 1]
    w1, b1, w2, b2, w3, b3 = np.split(head, np.cumsum(sizes)[:-1])
    assert b3.size == 1 and head.size == sum(sizes)
    x = np.random.default_rng(4).standard_normal((64, k))

    def lrelu(a):
        return np.where(a > 0, a, 0.01 * a)

    h1 = lrelu(x @ w1.reshape(k, 32) + b1)
    h2 = lrelu(h1 @ w2.reshape(32, 32) + b2)
    out = h2 @ w3 + b3
    with torch.no_grad():
        want = cv.mlp(torch.from_numpy(x).float())[:, 0].double().numpy()
    np.testing.assert_allclose(out, want, rtol=1e-5, atol=1e-6)
