"""Parity of the training slice's parts: the PyTorch port vs the JAX package,
on the CPU.

Same numpy inputs and the same weights on both sides (the JAX tree built
with ``jax.eval_shape`` and filled from a numpy seed, carried over by
``utils/flax_bridge``).  Covered here: the loss leg (MSE, LPIPS values and
input gradients), the LR schedule, one clip + Adam update on identical
gradients, BN running buffers after a train-mode forward, and the train
step's gradients in two legs split at the PTF boundary, as
``tests/test_backward_parity.py`` splits them (PTF's match decisions are
discrete, so each leg differentiates identical inputs):

1. trunk (backbone -> cost volume -> depth decoder -> hr_skip) to a fixed
   scalar on the fuse inputs;
2. fuse + head + adapter on identical fuse inputs, to a fixed scalar on
   the Gaussians.

The rasterizer leg is ``tests/test_torch_raster_grad.py``; the whole
step's 3-step loss curve is ``tests/test_torch_train_curve.py``.
Tolerances are stated beside each check with their cause.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from freesplat_tpu.models import backbone as jbb
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
from freesplat_tpu.training import losses as jlo
from freesplat_tpu.training import lpips as jlp
from freesplat_tpu.training import schedule as jsc
from freesplat_tpu_torch.models import backbone as tbb
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.training import losses as tlo
from freesplat_tpu_torch.training import lpips as tlp
from freesplat_tpu_torch.training import schedule as tsc
from freesplat_tpu_torch.training import trainer as ttr
from freesplat_tpu_torch.utils.flax_bridge import (
    jax_variables_to_torch,
    load_flax_variables,
    torch_to_jax_variables,
)
from tests.test_torch_cli import _one_torch_thread  # noqa: F401  (autouse fixture)
from tests.test_torch_encoder import _n, _t, fill_variables, jax_variables
from tests.test_torch_slice import make_scene

H = W = 64
D = 8


def _scaled_err(got, ref):
    scale = np.abs(ref).max()
    return np.abs(got).max() if scale == 0.0 else np.abs(got - ref).max() / scale


def _flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


# ---------------------------------------------------------------------------
# Loss leg.


def test_mse_and_lpips_match_flax():
    rng = np.random.default_rng(20)
    pred = rng.uniform(size=(1, 2, 32, 48, 3)).astype(np.float32)
    target = np.clip(pred + 0.2 * rng.standard_normal(pred.shape), 0, 1).astype(np.float32)
    flat = jnp.asarray(pred.reshape(2, 32, 48, 3))
    var = jax_variables(jlp.LPIPS(), flat, flat, seed=21)
    lp = tlp.make_lpips(var, device="cpu")  # strict bridge of the flax tree
    assert set(lp.state_dict()) == set(jax_variables_to_torch(var))

    jcfg = jlo.LossCfg()
    tcfg = tlo.LossCfg()
    # MSE: one float32 mean, summed in another order.
    np.testing.assert_allclose(
        float(tlo.mse_loss(tcfg.mse, _t(pred), _t(target))),
        float(jlo.mse_loss(jcfg.mse, jnp.asarray(pred), jnp.asarray(target))), rtol=1e-6)

    def jloss(p):
        total, parts = jlo.total_loss(jcfg, p, jnp.asarray(target), jnp.asarray(0), var)
        return total, parts

    (jtotal, jparts), jgrad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(pred))
    tp = _t(pred).requires_grad_(True)
    ttotal, tparts = tlo.total_loss(tcfg, tp, _t(target), 0, lp)
    ttotal.backward()
    assert set(tparts) == set(jparts) == {"mse", "lpips"}
    # LPIPS: 13 float32 convs and a channel normalization, summed in
    # another order (measured: equal here; MSE 4e-7 relative).
    for k in jparts:
        np.testing.assert_allclose(float(tparts[k].detach()), float(jparts[k]), rtol=1e-4,
                                   atol=1e-7,
                                   err_msg=k)
    np.testing.assert_allclose(float(ttotal), float(jtotal), rtol=1e-4)
    # Input gradient through VGG's backward (max-pool ties sit at ReLU
    # zeros, where both pass zero): 1e-4 after scaling (measured 9e-8).
    assert _scaled_err(_n(tp.grad), np.asarray(jgrad)) <= 1e-4

    # LPIPS distance of an image to itself is 0; the step gate shuts it.
    np.testing.assert_allclose(_n(lp(_t(pred[0]), _t(pred[0]))), 0.0, atol=1e-6)
    gated_j = jlo.lpips_loss(dataclasses.replace(jcfg.lpips, apply_after_step=5), var,
                             jnp.asarray(pred), jnp.asarray(target), jnp.asarray(3))
    gated_t = tlo.lpips_loss(dataclasses.replace(tcfg.lpips, apply_after_step=5), lp,
                             _t(pred), _t(target), 3)
    assert float(gated_j) == float(gated_t) == 0.0


def test_lpips_params_npz_round_trip(tmp_path):
    img = jnp.zeros((1, 32, 32, 3))
    var = jax_variables(jlp.LPIPS(), img, img, seed=22)
    path = str(tmp_path / "lpips.npz")
    jlp.save_lpips_params(var, path)  # written by the JAX package
    tree = tlp.load_lpips_params(path)
    for (kj, a), (kt, b) in zip(_flat(var), _flat(tree)):
        assert kj == kt
        np.testing.assert_array_equal(a, b)
    lp = tlp.make_lpips(tree, device="cpu")
    back = torch_to_jax_variables(lp)
    for (kj, a), (kt, b) in zip(sorted(_flat(var)), sorted(_flat(back))):
        assert kj == kt
        np.testing.assert_array_equal(a, b)
    with pytest.raises(NotImplementedError, match="npz"):
        tlp.load_lpips_params(str(tmp_path / "lpips.pth"))


def test_depth_losses_raise_until_ported():
    """The depth losses are ported: a non-zero weight yields its part (its
    value against JAX is ``tests/test_torch_depth_losses.py``), in
    ``total_loss`` and in a train step that reads the target's sensor
    depth; zero weights build none."""
    cfg = tlo.LossCfg(depth=tlo.LossDepthCfg(normals_weight=0.1))
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.uniform(size=(1, 1, 8, 8, 3)).astype(np.float32))
    depth = 1.0 + x[..., 0]
    intr = torch.tensor([[[[1.0, 0, 0.5], [0, 1.0, 0.5], [0, 0, 1]]]])
    ctx = {"rendered_depth": depth, "gt_depth": depth.flip(-1), "intrinsics": intr}
    total, parts = tlo.total_loss(cfg, x, x, 0, depth_ctx=ctx)
    assert set(parts) == {"mse", "depth_normals"}
    assert float(parts["depth_normals"]) > 0 and float(total) == float(parts["depth_normals"])
    _, parts = tlo.total_loss(tlo.LossCfg(), x, x, 0, depth_ctx=ctx)
    assert set(parts) == {"mse"}  # zero weights: no depth term, no LPIPS module

    tcfg = ttr.TrainCfg(
        encoder=tenc.EncoderFreeSplatCfg(num_depth_candidates=D, d_feature=16, matching_dim=8,
                                         adapter=TAdapterCfg(sh_degree=1), train_bn=False),
        decoder=dataclasses.replace(ttr.DecoderCfg(), sh_degree=1),
        loss=tlo.LossCfg(lpips=None, depth=tlo.LossDepthCfg(scale_invariant_weight=0.1,
                                                            mv_consistency_weight=0.1)),
    )
    batch = make_scene(3, h=32, w=32)
    batch["target"]["depth"] = rng.uniform(1.0, 3.0, (1, 2, 32, 32)).astype(np.float32)
    state = ttr.init_state(tcfg, seed=0, device="cpu")
    _, metrics = ttr.make_train_step(tcfg)(state, batch)
    for k in ("loss_depth_si", "loss_depth_mv"):
        assert np.isfinite(float(metrics[k])) and float(metrics[k]) > 0, k
    assert "loss_depth_grad" not in metrics and "loss_depth_normals" not in metrics


# ---------------------------------------------------------------------------
# Schedule and optimizer.


@pytest.mark.parametrize("kind", ["scannet", "short", "linear"])
def test_schedule_matches_optax(kind):
    kw = {
        "scannet": dict(lr=1e-4, warm_up_steps=100, max_steps=300_001),
        "short": dict(lr=1e-3, warm_up_steps=3, max_steps=10),
        "linear": dict(lr=1e-3, warm_up_steps=4, max_steps=10, cosine_lr=False),
    }[kind]
    jcfg, tcfg = jsc.OptimizerCfg(**kw), tsc.OptimizerCfg(**kw)
    jsched, tsched = jsc.make_schedule(jcfg), tsc.make_schedule(tcfg)
    warm, last = kw["warm_up_steps"], kw["max_steps"]
    for step in (0, 1, warm - 1, warm, warm + 1, (warm + last) // 2, last - 1, last, last + 5):
        # The JAX schedule runs in float32; the port's in float64.
        np.testing.assert_allclose(tsched(step), float(jsched(jnp.asarray(step, jnp.int32))),
                                   rtol=2e-6, atol=1e-14, err_msg=f"{kind} step {step}")
    if kind != "linear":  # the peak sits at the warm-up boundary, not one step before
        assert tsched(warm) == pytest.approx(kw["lr"], rel=1e-12)
        assert tsched(warm - 1) < kw["lr"]


def test_clip_and_adam_update_match_optax():
    """Two updates on identical gradients: the first clipped (|g| above
    the limit), the second not.  Parameters ~1e-2 keep the comparison
    well above float32 rounding of the parameter itself."""
    rng = np.random.default_rng(30)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 2, 3, 3)}
    params = {k: (1e-2 * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (scale * rng.standard_normal(s)).astype(np.float32) for k, s in shapes.items()}
             for scale in (1.0, 1e-3)]
    grads[0]["b"][:2] = 1e-9  # gradients near Adam's epsilon
    cfg_kw = dict(lr=1e-3, warm_up_steps=2, max_steps=10, gradient_clip_val=0.5)
    jcfg, tcfg = jsc.OptimizerCfg(**cfg_kw), tsc.OptimizerCfg(**cfg_kw)

    tx = jsc.make_optimizer(jcfg)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jp)
    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    opt = tsc.make_optimizer(tcfg, list(tp.values()))
    sched = tsc.make_schedule(tcfg)
    norms = []
    for step, g in enumerate(grads):
        upd, jstate = tx.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jp)
        jp = optax.apply_updates(jp, upd)
        for k, p in tp.items():
            p.grad = _t(g[k])
        norms.append(float(tsc.clip_grad_global_norm([p.grad for p in tp.values()],
                                                     tcfg.gradient_clip_val)))
        for group in opt.param_groups:
            group["lr"] = sched(step)
        opt.step()
        for k in shapes:
            moved = np.abs(_n(tp[k]).astype(np.float64) - params[k]).max()
            err = np.abs(_n(tp[k]).astype(np.float64) - np.asarray(jp[k])).max()
            # optax takes Adam's bias correction 1 - 0.999^t in float32
            # (relative error ~6e-8 / 0.001t, ~3e-5 on the update at t = 2);
            # torch takes it in float64.  Plus one float32 ulp of a 1e-2
            # parameter (~9e-10).
            assert err <= 1e-4 * moved + 2e-9, (step, k, err, moved)
    assert norms[0] > cfg_kw["gradient_clip_val"] > norms[1]


# ---------------------------------------------------------------------------
# BN in training mode.


def test_bn_running_buffers_match_flax():
    x = np.random.default_rng(4).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    jm = jbb.EfficientNetV2S(train_bn=True)
    var = jax_variables(jm, jnp.asarray(x), seed=4)
    _, upd = jax.jit(lambda v, a: jm.apply(v, a, mutable=["batch_stats"]))(var, jnp.asarray(x))
    tm = load_flax_variables(tbb.EfficientNetV2S(train_bn=True), var).train()
    with torch.no_grad():
        tm(_t(x))
    got = dict(_flat(torch_to_jax_variables(tm)["batch_stats"]))
    want = dict(_flat(jax.tree_util.tree_map(np.asarray, upd["batch_stats"])))
    before = dict(_flat(var["batch_stats"]))
    assert got.keys() == want.keys()
    for k in want:
        assert not np.array_equal(got[k], before[k]), k  # the buffers moved
        # ra = 0.9 ra + 0.1 stat.  The batch statistics inherit the
        # features' float32 conditioning at 64x64 (test_torch_encoder's
        # 5e-3 at stride 32); measured max abs 6e-4 on the buffers.
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3, atol=1e-3, err_msg="/".join(k))
    # eval() (serving) leaves them untouched.
    tm.eval()
    snap = {k: v.clone() for k, v in tm.state_dict().items()}
    with torch.no_grad():
        tm(_t(x))
    assert all(torch.equal(v, snap[k]) for k, v in tm.state_dict().items())


# ---------------------------------------------------------------------------
# Gradient legs of the train step.


def test_batchnorm_gradients_match_flax():
    """One batch-statistics BN layer, well conditioned (zero-mean inputs,
    512 samples per channel): input, scale and bias gradients agree to
    float32 rounding, so the backward formulas are the same."""
    rng = np.random.default_rng(42)
    x = rng.standard_normal((2, 16, 16, 6)).astype(np.float32)
    w = rng.standard_normal(x.shape).astype(np.float32)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-3)
    var = jax_variables(jm, jnp.asarray(x), seed=43)

    def jloss(params, a):
        y, _ = jm.apply({"params": params, "batch_stats": var["batch_stats"]}, a,
                        mutable=["batch_stats"])
        return jnp.sum(y * w)

    jgp, jgx = jax.jit(jax.grad(jloss, argnums=(0, 1)))(var["params"], jnp.asarray(x))
    tm = load_flax_variables(tbb.BatchNorm(6, use_running_average=False), var).train()
    tx = _t(x).requires_grad_(True)
    (tm(tx) * _t(w)).sum().backward()
    assert _scaled_err(_n(tx.grad), np.asarray(jgx)) <= 1e-5
    assert _scaled_err(_n(tm.weight.grad), np.asarray(jgp["scale"])) <= 1e-5
    assert _scaled_err(_n(tm.bias.grad), np.asarray(jgp["bias"])) <= 1e-5
    # The same forward moved the running buffers as flax's mutable
    # batch_stats, to float32 rounding (the variance is rescaled from the
    # unbiased n / (n - 1) term).
    _, upd = jm.apply(var, jnp.asarray(x), mutable=["batch_stats"])
    for name, key in (("running_mean", "mean"), ("running_var", "var")):
        np.testing.assert_allclose(_n(getattr(tm, name)), np.asarray(upd["batch_stats"][key]),
                                   rtol=1e-6, atol=1e-7, err_msg=name)


@pytest.fixture(scope="module")
def slice_setup():
    batch = make_scene(0)
    jctx = {k: jnp.asarray(a) for k, a in batch["context"].items()}
    jcfg = jenc.EncoderFreeSplatCfg(num_depth_candidates=D, adapter=JAdapterCfg(sh_degree=2))
    shapes = jax.eval_shape(lambda c: jenc.EncoderFreeSplat(jcfg).init(jax.random.PRNGKey(0), c),
                            jctx)
    return batch, jctx, jcfg, fill_variables(shapes, seed=1)


def _port_encoder(var, train_bn=True):
    tcfg = tenc.EncoderFreeSplatCfg(num_depth_candidates=D, adapter=TAdapterCfg(sh_degree=2),
                                    train_bn=train_bn)
    return load_flax_variables(tenc.EncoderFreeSplat(tcfg), var).train()


_TRUNK_KEYS = ("feat_v", "coords_v", "dens_v", "wt_v", "depth_v")


def _torch_param_grads(module):
    return {k: p.grad.numpy() for k, p in module.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("train_bn", [False, True], ids=["running_average", "batch_stats"])
def test_trunk_gradients_match(slice_setup, train_bn):
    batch, jctx, jcfg, var = slice_setup
    mt = jenc.EncoderFreeSplat(dataclasses.replace(jcfg, trunk_only=True, train_bn=train_bn))
    apply = jax.jit(lambda params, c: mt.apply(
        {"params": params, "batch_stats": var["batch_stats"]}, c, mutable=["batch_stats"])[0])
    out_shapes = jax.eval_shape(apply, var["params"], jctx)
    rng = np.random.default_rng(40)
    weights = {k: rng.standard_normal(out_shapes[k].shape).astype(np.float32)
               for k in _TRUNK_KEYS}

    def jloss(params):
        out = apply(params, jctx)
        return sum(jnp.sum(out[k] * weights[k]) for k in _TRUNK_KEYS)

    jgrads = jax_variables_to_torch({"params": jax.jit(jax.grad(jloss))(var["params"])})
    tm = _port_encoder(var, train_bn)
    out = tm.trunk({k: _t(a) for k, a in batch["context"].items()})
    sum((out[k] * _t(weights[k])).sum() for k in _TRUNK_KEYS).backward()
    tgrads = _torch_param_grads(tm)
    trunk = sorted(k for k in jgrads if not k.startswith("fuse."))
    # The lower-scale depth heads do not reach the fuse inputs: zero in
    # JAX, no gradient at all in torch.
    assert set(tgrads) <= set(trunk)
    assert all(not jgrads[k].any() for k in set(trunk) - set(tgrads))
    keys = sorted(tgrads)
    errs = {k: _scaled_err(tgrads[k], jgrads[k].numpy()) for k in keys}
    worst = max(errs, key=errs.get)
    ref = np.concatenate([jgrads[k].numpy().ravel() for k in keys])
    got = np.concatenate([tgrads[k].ravel() for k in keys])
    rel = np.linalg.norm(got - ref) / np.linalg.norm(ref)
    if not train_bn:
        # Running averages: ~40 float32 conv layers with random weights,
        # summed in another order.  Measured worst leaf 1.1e-3 after
        # scaling by its max, median 1.2e-4, whole vector 1.0e-4 (6.4e-4,
        # 7.8e-5, 6.7e-5 on one torch thread, as this file runs, on an
        # AVX-512 host; with two or more threads torch's oneDNN
        # convolutions there read 1.2e-2, 1.2e-3, 8.4e-4).
        assert errs[worst] <= 3e-3, (worst, errs[worst])
        assert np.median(list(errs.values())) <= 5e-4
        assert rel <= 5e-4
    else:
        # Batch statistics over 2 images at 64x64 (8 samples per channel at
        # stride 32) with random weights: per-channel means far above the
        # spread, so normalizing amplifies float32 rounding layer after
        # layer, and flax's E[x^2] - E[x]^2 variance cancels on top
        # (ROADMAP section 3; test_batchnorm_gradients_match_flax shows the
        # formulas agree when conditioned).  Measured: whole vector 1.4e-2,
        # median leaf 1.2e-2 after scaling; the worst leaves (~2) are BN
        # biases whose true gradient is ~0 because the next batch-statistics
        # BN removes any per-channel shift.  So the vector is compared.
        assert rel <= 5e-2, rel
        assert np.dot(got, ref) / (np.linalg.norm(got) * np.linalg.norm(ref)) >= 0.998


def test_fuse_gradients_match(slice_setup):
    batch, jctx, jcfg, var = slice_setup
    tm = _port_encoder(var)
    mt = jenc.EncoderFreeSplat(dataclasses.replace(jcfg, trunk_only=True))
    jout, _ = jax.jit(lambda v, c: mt.apply(v, c, mutable=["batch_stats"]))(var, jctx)
    inputs = [np.asarray(jout[k][0]) for k in _TRUNK_KEYS]  # scene 0: identical fuse inputs
    extr, intr = (batch["context"][k][0] for k in ("extrinsics", "intrinsics"))
    fs = jenc._FuseScene(jcfg, (H, W))
    fvar = {"params": var["params"]["fuse"]}
    n = inputs[0].shape[0] * inputs[0].shape[1]
    rng = np.random.default_rng(41)
    wts = [rng.standard_normal((n,) + s).astype(np.float32) for s in ((3,), (3, 3), (3, 9), ())]

    def scalar(g, mask, ws):
        fields = (g.means, g.covariances, g.harmonics, g.opacities)
        return sum(((f * w) * mask.reshape((n,) + (1,) * (w.ndim - 1))).sum()
                   for f, w in zip(fields, ws))

    def jloss(params, *xs):
        g, _, _ = fs.apply({"params": params}, *xs, jnp.asarray(extr), jnp.asarray(intr))
        return scalar(g, g.mask.astype(jnp.float32), [jnp.asarray(w) for w in wts]), g.mask

    (_, jmask), jg = jax.jit(jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True))(
        fvar["params"], *[jnp.asarray(a) for a in inputs])
    xs = [_t(a).requires_grad_(True) for a in inputs]
    tm.zero_grad(set_to_none=True)
    g, _, _ = tm.fuse(*xs, _t(extr), _t(intr), (H, W))
    np.testing.assert_array_equal(_n(g.mask), np.asarray(jmask))  # same PTF decisions
    scalar(g, g.mask.float(), [_t(w) for w in wts]).backward()
    jparams = jax_variables_to_torch({"params": {"fuse": jg[0]}})
    tparams = _torch_param_grads(tm)
    assert set(tparams) == set(jparams)
    # PTF averages, the GRU and the adapter's exp/normalize: float32 only.
    for k in jparams:
        err = _scaled_err(tparams[k], jparams[k].numpy())
        assert err <= 1e-4, (k, err)
    for name, x, ref in zip(_TRUNK_KEYS, xs, jg[1:]):
        err = _scaled_err(_n(x.grad), np.asarray(ref))
        assert err <= 1e-4, (name, err)
