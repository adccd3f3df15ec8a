"""The whole train step, JAX vs the PyTorch port, on the CPU: a 3-step loss
curve from identical weights.

2 context views at 64x64, D = 8 depth planes, 2 target views, MSE +
0.05 LPIPS (LPIPS weights from a numpy seed), Adam with the one-cycle
schedule and global-norm clipping.  The JAX side is
``freesplat_tpu.training.trainer.make_train_step`` (Pallas in interpret
mode), the port's ``make_train_step`` runs the plain versions of its
kernels.  Weights come from one numpy-filled flax tree, bridged.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
from freesplat_tpu.models.decoder import DecoderCfg as JDecoderCfg
from freesplat_tpu.training import lpips as jlp
from freesplat_tpu.training import trainer as jtr
from freesplat_tpu.training.losses import LossCfg as JLossCfg
from freesplat_tpu.training.schedule import OptimizerCfg as JOptimizerCfg
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.models.decoder import DecoderCfg as TDecoderCfg
from freesplat_tpu_torch.training import trainer as ttr
from freesplat_tpu_torch.training.lpips import make_lpips
from freesplat_tpu_torch.training.losses import LossCfg as TLossCfg
from freesplat_tpu_torch.training.schedule import OptimizerCfg as TOptimizerCfg
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables, torch_to_jax_variables
from tests.test_torch_encoder import fill_variables, jax_variables
from tests.test_torch_slice import make_scene

D = 8
STEPS = 3
OPT = dict(lr=1e-4, warm_up_steps=2, max_steps=10, gradient_clip_val=0.01)


def test_three_step_loss_curve_matches_jax():
    batches = [make_scene(s) for s in range(STEPS)]
    arrays = [{k: {kk: jnp.asarray(vv) for kk, vv in b[k].items()} for k in ("context", "target")}
              for b in batches]
    jcfg = jtr.TrainCfg(
        encoder=jenc.EncoderFreeSplatCfg(num_depth_candidates=D, adapter=JAdapterCfg(sh_degree=2)),
        decoder=JDecoderCfg(sh_degree=2), loss=JLossCfg(), optimizer=JOptimizerCfg(**OPT),
    )
    tcfg = ttr.TrainCfg(
        encoder=tenc.EncoderFreeSplatCfg(num_depth_candidates=D, adapter=TAdapterCfg(sh_degree=2)),
        decoder=TDecoderCfg(sh_degree=2), loss=TLossCfg(), optimizer=TOptimizerCfg(**OPT),
    )
    shapes = jax.eval_shape(
        lambda c: jenc.EncoderFreeSplat(jcfg.encoder).init(jax.random.PRNGKey(0), c),
        arrays[0]["context"])
    var = fill_variables(shapes, seed=1)
    img = jnp.zeros((1, 64, 64, 3))
    lpips_var = jax_variables(jlp.LPIPS(), img, img, seed=2)

    tx = jtr.make_optimizer(jcfg.optimizer)
    jstate = {"params": var["params"], "batch_stats": var["batch_stats"],
              "opt_state": tx.init(var["params"]), "step": jnp.zeros((), jnp.int32)}
    jstep = jtr.make_train_step(jcfg, lpips_params=lpips_var)
    tstate = ttr.init_state(tcfg, seed=0, device="cpu")
    load_flax_variables(tstate["encoder"], var)  # in place: the optimizer keeps its params
    tstep = ttr.make_train_step(tcfg, lpips=make_lpips(lpips_var, device="cpu"))

    jcurve, tcurve = [], []
    for b, a in zip(batches, arrays):
        jstate, jm = jstep(jstate, a)
        tstate, tm = tstep(tstate, b)
        jcurve.append({k: float(v) for k, v in jm.items()})
        tcurve.append({k: float(v) for k, v in tm.items()})
    assert tstate["step"] == STEPS
    for i, (j, t) in enumerate(zip(jcurve, tcurve)):
        assert set(t) == set(j), i
        assert t["dropped_instances"] == j["dropped_instances"] == 0
        # Gaussian counts come from PTF's discrete matches on weights that
        # drift apart by rounding: measured 0, 0 and 6 of 8192 slots apart.
        assert abs(t["num_gaussians"] - j["num_gaussians"]) <= 5e-3 * 2 * 64 * 64, i
        # Step 0 shares its weights exactly; later steps inherit Adam
        # updates of ~lr * sign(g), where leaves with |g| near float32 noise
        # may step the other way, and BN's conditioning (ROADMAP section 3).
        # The loss moves by 2 % and 39 % between the steps; the curves
        # agree far inside that: measured relative difference 2e-6, 1.4e-5
        # and 3.8e-4 (loss), LPIPS (a ~1e-4 term) within 4e-4 of itself.
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=2e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(t["loss_mse"], j["loss_mse"], rtol=2e-3, err_msg=f"step {i}")
        np.testing.assert_allclose(t["loss_lpips"], j["loss_lpips"], rtol=2e-2, atol=1e-6,
                                   err_msg=f"step {i}")
        np.testing.assert_allclose(t["psnr"], j["psnr"], atol=1e-2, err_msg=f"step {i}")
    # The curve moved (the updates did something) in the same direction.
    dj = np.diff([c["loss"] for c in jcurve])
    dt = np.diff([c["loss"] for c in tcurve])
    assert np.all(np.sign(dj) == np.sign(dt))
    # BN running buffers carried out of the step, as flax's batch_stats.
    got = dict(_leaves(torch_to_jax_variables(tstate["encoder"])["batch_stats"]))
    want = dict(_leaves(jax.tree_util.tree_map(np.asarray, jstate["batch_stats"])))
    start = dict(_leaves(var["batch_stats"]))
    assert got.keys() == want.keys()
    assert all(not np.array_equal(got[k], start[k]) for k in got)  # every buffer moved
    # Three updates of batch statistics from weights that drift apart: the
    # stride-32 variances differ by up to ~1.5 % element-wise (the BN
    # conditioning above), so the whole buffer vector is compared;
    # measured relative difference 2.9e-3.
    a = np.concatenate([got[k].ravel() for k in sorted(got)])
    b = np.concatenate([want[k].ravel() for k in sorted(got)])
    assert np.linalg.norm(a - b) / np.linalg.norm(b) <= 1e-2


def _leaves(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), np.asarray(v)


def test_fit_logs_late_and_warns_on_drops(monkeypatch, capsys):
    """``fit``'s host loop (the JAX one's logic): metrics logged one
    interval late with ``steps_per_s``, the dropped-instance warning, and
    the checkpoint/validation callbacks at their intervals."""
    def fake_make_train_step(cfg, lpips=None):
        def step(state, batch, timings=None):
            metrics = {"loss": torch.tensor(1.0 / (state["step"] + 1)),
                       "dropped_instances": torch.tensor(float(state["step"] == 2))}
            return {**state, "step": state["step"] + 1}, metrics
        return step

    monkeypatch.setattr(ttr, "make_train_step", fake_make_train_step)
    logged, ckpts, vals = [], [], []
    state = ttr.fit(ttr.TrainCfg(log_every=2), {"step": 0}, iter(range(10)), max_steps=7,
                    log_fn=lambda step, v: logged.append((step, v)),
                    checkpoint_fn=lambda step, st: ckpts.append(step), checkpoint_every=3,
                    val_fn=lambda step, st: vals.append(step), val_every=4)
    assert state["step"] == 7
    assert [s for s, _ in logged] == [0, 2, 4, 6]
    assert logged[1][1]["loss"] == pytest.approx(1.0 / 3) and "steps_per_s" in logged[1][1]
    assert ckpts == [3, 6] and vals == [4]
    out = capsys.readouterr().out
    assert "WARNING step 2: rasterizer dropped 1 instances" in out
