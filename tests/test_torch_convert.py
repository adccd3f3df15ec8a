"""Weights from elsewhere in the PyTorch port vs the JAX package, on the CPU.

``utils/torch_convert.py`` (timm EfficientNetV2-S and ``lpips`` VGG state
dicts, strict both ways), ``scripts/convert_weights.py`` (the CLI, its
``verify`` report, ``load_tree_npz``, ``load_backbone_npz``),
``training/lpips.py::load_lpips_params`` on a ``.pth`` and
``scripts/lpips_leg.py``; and the checkpoint route between the packages:
a keypath ``.npz`` that either package writes and the other reads.  No
pretrained file ships: the backbone's state dict is synthesized from the
774-key manifest ``tests/fixtures/timm_tf_efficientnetv2_s_manifest.json``
(``chip_smoke.timm_state_dict``) and the LPIPS one by
``lpips_leg.synthesize_lpips_pth``.  Tolerances are
stated beside each check.
"""
import json
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from freesplat_tpu.models import backbone as jbb
from freesplat_tpu.models import encoder as jenc
from freesplat_tpu.models.adapter import GaussianAdapterCfg as JAdapterCfg
from freesplat_tpu.scripts import convert_weights as jcw
from freesplat_tpu.scripts.lpips_leg import synthesize_lpips_pth as jax_synthesize
from freesplat_tpu.training import checkpoint as jckpt
from freesplat_tpu.training import lpips as jlp
from freesplat_tpu.utils import torch_convert as jtc
from freesplat_tpu_torch import main as tmain
from freesplat_tpu_torch.models import backbone as tbb
from freesplat_tpu_torch.models import encoder as tenc
from freesplat_tpu_torch.models.adapter import GaussianAdapterCfg as TAdapterCfg
from freesplat_tpu_torch.scripts import convert_weights as tcw
from freesplat_tpu_torch.scripts import lpips_leg as tleg
from freesplat_tpu_torch.training import lpips as tlp
from freesplat_tpu_torch.utils import torch_convert as ttc
from freesplat_tpu_torch.utils.flax_bridge import load_flax_variables, torch_to_jax_variables
from chip_smoke import timm_state_dict
from tests.test_torch_encoder import fill_variables
from tests.test_torch_slice import make_scene

@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def lpips_state_dict(tmp_path, torchvision_layout=False):
    path = tmp_path / "lpips.pth"
    tleg.synthesize_lpips_pth(path)
    sd = torch.load(path, weights_only=True)
    if torchvision_layout:  # features.N / linN names
        sd = {re.sub(r"^lins\.(\d)\.", r"lin\1.", re.sub(r"^net\.slice\d\.", "features.", k)): v
              for k, v in sd.items()}
    return sd


def _numpy(sd):
    return {k: v.numpy() for k, v in sd.items()}


def assert_same_tree(a, b, path=""):
    assert sorted(a) == sorted(b), (path, sorted(set(a) ^ set(b))[:5])
    for k in a:
        if isinstance(a[k], dict):
            assert_same_tree(a[k], b[k], f"{path}/{k}")
        else:
            x, y = np.asarray(a[k]), np.asarray(b[k])
            assert x.dtype == y.dtype and np.array_equal(x, y), f"{path}/{k}"


def test_effnet_conversion_matches_jax():
    sd = timm_state_dict()
    assert len(sd) == 774
    tparams, tstats = ttc.convert_efficientnetv2_s(sd)
    jparams, jstats = jtc.convert_efficientnetv2_s(_numpy(sd))
    assert_same_tree(tparams, jparams)
    assert_same_tree(tstats, jstats)
    # Through the bridge onto the port's backbone, against the JAX backbone
    # on the same tree (running-average BN: tests/test_torch_encoder.py's
    # tolerance, 5e-5 a feature map).
    x = np.random.default_rng(2).uniform(size=(2, 64, 64, 3)).astype(np.float32)
    tm = load_flax_variables(tbb.EfficientNetV2S(train_bn=False),
                             {"params": tparams, "batch_stats": tstats}).eval()
    jf = jax.jit(jbb.EfficientNetV2S(train_bn=False).apply)(
        {"params": jparams, "batch_stats": jstats}, jnp.asarray(x))
    with torch.no_grad():
        tf = tm(torch.from_numpy(x))
    for a, b in zip(tf, jf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5)


@pytest.mark.parametrize("layout", ["lpips", "torchvision"])
def test_lpips_conversion_matches_jax(tmp_path, layout):
    sd = lpips_state_dict(tmp_path, torchvision_layout=layout == "torchvision")
    assert any(k.startswith("features." if layout == "torchvision" else "net.") for k in sd)
    t = ttc.convert_lpips_vgg(sd)
    assert_same_tree(t, jtc.convert_lpips_vgg(_numpy(sd)))
    # Distances through both LPIPS modules on the converted weights:
    # float32 VGG16 at 64x64, summed in another order (measured ~1e-7).
    rng = np.random.default_rng(3)
    a, b = (rng.uniform(size=(2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    jd = np.asarray(jax.jit(jlp.LPIPS().apply)(t, a, b))
    with torch.no_grad():
        td = tlp.make_lpips(t, device="cpu")(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("case", ["effnet_extra", "effnet_missing", "lpips_extra",
                                  "lpips_missing"])
def test_strict_conversion_refuses(tmp_path, case):
    if case.startswith("effnet"):
        sd, convert, jconvert = timm_state_dict(), ttc.convert_efficientnetv2_s, \
            jtc.convert_efficientnetv2_s
        key = "blocks.3.2.se.conv_reduce.weight"
    else:
        sd, convert, jconvert = lpips_state_dict(tmp_path), ttc.convert_lpips_vgg, \
            jtc.convert_lpips_vgg
        key = "net.slice3.12.weight"
    if case.endswith("extra"):
        sd["blocks.0.0.mystery.weight"] = torch.zeros(3, 3)
        for fn, arg in ((convert, sd), (jconvert, _numpy(sd))):
            with pytest.raises(ValueError, match="mystery"):
                fn(arg)
        convert(sd, strict=False)  # the check is what refuses it
        # The heads and counters a checkpoint carries are ignorable.
        sd.pop("blocks.0.0.mystery.weight")
        sd["classifier.weight"] = torch.zeros(2, 2)
        convert(sd)
    else:
        del sd[key]
        for fn, arg in ((convert, sd), (jconvert, _numpy(sd))):
            with pytest.raises(KeyError):
                fn(arg)


@pytest.mark.parametrize("kind", ["backbone", "lpips"])
def test_convert_cli_round_trip_and_verify(tmp_path, kind, capsys):
    src = tmp_path / "src.pth"
    if kind == "backbone":
        torch.save(timm_state_dict(), src)
    else:
        jax_synthesize(src)  # the JAX package's synthesized file
    tdst, jdst = tmp_path / "port.npz", tmp_path / "jax.npz"
    tcw.main(["verify", kind, str(src), str(tdst)], device="cpu")
    jcw.main(["verify", kind, str(src), str(jdst)])
    # The same keypath .npz: every array equal, and each package reads the
    # other's file.
    t, j = np.load(tdst), np.load(jdst)
    assert sorted(t.files) == sorted(j.files)
    for k in t.files:
        assert t[k].dtype == j[k].dtype and np.array_equal(t[k], j[k]), k
    assert_same_tree(tcw.load_tree_npz(str(jdst)),
                     jax.tree_util.tree_map(np.asarray, jcw.load_tree_npz(str(tdst))))
    # verify's report: JAX's keys; the forward on the port's modules within
    # float32 reordering of JAX's (relative 1e-4 on the means and stds,
    # 1e-4 on the LPIPS distances).
    tr = json.loads((tmp_path / "port.npz.verify.json").read_text())
    jr = json.loads((tmp_path / "jax.npz.verify.json").read_text())
    assert sorted(tr) == sorted(jr) and tr["kind"] == kind
    assert tr.get("timm_ok") is None and tr.get("lpips_ok") is None
    if kind == "backbone":
        assert [s["shape"] for s in tr["scales"]] == [s["shape"] for s in jr["scales"]]
        assert all(s["finite"] for s in tr["scales"])
        for a, b in zip(tr["scales"], jr["scales"]):
            for f in ("mean", "std"):
                assert abs(a[f] - b[f]) <= 1e-4 * max(1.0, abs(b[f])), (f, a, b)
    else:
        assert tr["finite"] and tr["positive"] == jr["positive"]
        np.testing.assert_allclose(tr["distances"], jr["distances"], rtol=1e-4)
    with pytest.raises(SystemExit):
        tcw.main([kind, str(src)], device="cpu")  # usage


def test_load_lpips_params_reads_pth(tmp_path, monkeypatch):
    pth = tmp_path / "lpips.pth"
    jax_synthesize(pth)
    npz = tmp_path / "lpips.npz"
    tcw.main(["lpips", str(pth), str(npz)], device="cpu")
    tree = tlp.load_lpips_params(str(pth))
    assert_same_tree(tree, jax.tree_util.tree_map(np.asarray, jlp.load_lpips_params(str(pth))))
    assert_same_tree(tree, tlp.load_lpips_params(str(npz)))
    # The CLI's LPIPS takes either form, with the same weights.
    loaded = []
    for path in (pth, npz):
        cfg = tmain.load_config([f"loss.lpips.weights_path={path}"])
        loaded.append(tmain._load_lpips(cfg, device="cpu").state_dict())
    for k, v in loaded[0].items():
        assert torch.equal(v, loaded[1][k]), k


def test_load_backbone_npz_grafts_the_converted_backbone(tmp_path):
    src, dst = tmp_path / "effnet.pth", tmp_path / "effnet.npz"
    torch.save(timm_state_dict(), src)
    tcw.main(["backbone", str(src), str(dst)], device="cpu")
    cfg = tenc.EncoderFreeSplatCfg(num_depth_candidates=8)
    enc = tenc.make_encoder(cfg, device="cpu", seed=0)
    head_before = {k: v.clone() for k, v in enc.state_dict().items()
                   if not k.startswith("backbone.")}
    tcw.load_backbone_npz(enc, str(dst))
    # The backbone equals JAX's graft of the same file; nothing else moved.
    jvars = {"params": {"backbone": {}}, "batch_stats": {"backbone": {}}}
    jgraft = jcw.load_backbone_npz(jvars, str(dst))
    own = torch_to_jax_variables(enc)
    for coll in ("params", "batch_stats"):
        assert_same_tree(own[coll]["backbone"],
                         jax.tree_util.tree_map(np.asarray, jgraft[coll]["backbone"]))
    for k, v in enc.state_dict().items():
        if k in head_before:
            assert torch.equal(v, head_before[k]), k
    # A wrong tree is refused strictly.
    lp = tmp_path / "lpips.npz"
    jax_synthesize(tmp_path / "lpips.pth")
    tcw.main(["lpips", str(tmp_path / "lpips.pth"), str(lp)], device="cpu")
    with pytest.raises(ValueError, match="do not match"):
        tcw.load_backbone_npz(enc, str(lp))


def test_lpips_leg_on_the_cpu(tmp_path, monkeypatch):
    """The leg at 32x32 (D = 8): its synthesized .pth equals the JAX
    package's, its .npz equals JAX's conversion, and the run logs a finite
    ``loss_lpips`` from step 0."""
    monkeypatch.chdir(tmp_path)  # the trainer logs under outputs/local
    out = tmp_path / "leg"
    stats = tleg.main(["--steps", "1", "--image-shape", "32,32", "--out", str(out),
                       "encoder.num_depth_candidates=8", "trainer.log_every=1"], device="cpu")
    assert stats == {}  # memory_stats is the card's
    assert json.loads((out / "memory.json").read_text()) == {}
    jax_synthesize(tmp_path / "jax.pth")
    mine = torch.load(out / "lpips_synthetic.pth", weights_only=True)
    theirs = torch.load(tmp_path / "jax.pth", weights_only=True)
    assert sorted(mine) == sorted(theirs)
    for k in mine:
        assert torch.equal(mine[k], theirs[k]), k
    jcw.main(["lpips", str(tmp_path / "jax.pth"), str(tmp_path / "jax.npz")])
    a, b = np.load(out / "lpips_synthetic.npz"), np.load(tmp_path / "jax.npz")
    assert all(np.array_equal(a[k], b[k]) for k in b.files) and sorted(a.files) == sorted(b.files)
    steps = [json.loads(line) for line in (out / "metrics_tail.jsonl").read_text().splitlines()]
    assert [m["step"] for m in steps] == [0, 1]
    assert all(np.isfinite(m["loss_lpips"]) and m["loss_lpips"] != 0 for m in steps)


# ---------------------------------------------------------------------------
# Checkpoints between the packages: a keypath .npz of flax variables.


@pytest.fixture(scope="module")
def encoders():
    """One encoder configuration in both packages (running-average BN, so
    outputs do not depend on batch statistics), the JAX forward jitted, and
    a 32x32 scene."""
    batch = make_scene(11, v_ctx=2, v_tgt=1, h=32, w=32)
    jcfg = jenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=JAdapterCfg(sh_degree=1),
                                    train_bn=False)
    tcfg = tenc.EncoderFreeSplatCfg(num_depth_candidates=8, adapter=TAdapterCfg(sh_degree=1),
                                    train_bn=False)
    jm = jenc.EncoderFreeSplat(jcfg)
    jctx = {k: jnp.asarray(a) for k, a in batch["context"].items()}
    shapes = jax.eval_shape(lambda c: jm.init(jax.random.PRNGKey(0), c), jctx)
    return batch, jctx, shapes, jax.jit(jm.apply), tcfg


def assert_same_outputs(tout, jout):
    """tests/test_torch_slice.py's tolerances (depth 1e-3 relative, the
    Gaussians on the PTF slots valid in both)."""
    for k in ("depth_s-1", "densities"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]), rtol=1e-3, atol=1e-4)
    jg, tg = jout["gaussians"], tout["gaussians"]
    jmask, tmask = np.asarray(jg.mask), tg.mask.numpy()
    assert (jmask == tmask).mean() >= 0.999
    both = jmask & tmask
    for f, rtol, atol in (("means", 1e-3, 1e-4), ("covariances", 1e-3, 5e-6),
                          ("harmonics", 1e-3, 1e-4), ("opacities", 1e-3, 1e-4)):
        np.testing.assert_allclose(getattr(tg, f).numpy()[both],
                                   np.asarray(getattr(jg, f))[both], rtol=rtol, atol=atol)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_checkpoint_interchange(tmp_path, encoders, direction):
    batch, jctx, shapes, japply, tcfg = encoders
    tctx = {k: torch.from_numpy(a) for k, a in batch["context"].items()}
    if direction == "jax_to_port":
        # An orbax checkpoint of the JAX training state's variables,
        # restored by JAX, written by JAX's keypath writer, read by the port.
        var = fill_variables(shapes, seed=12)
        state = {"params": var["params"], "batch_stats": var["batch_stats"],
                 "step": jnp.asarray(5, jnp.int32)}
        jckpt.save_checkpoint(str(tmp_path / "orbax"), 5, state)
        restored = jckpt.restore_checkpoint(str(tmp_path / "orbax"), 5, state)
        jvars = {"params": restored["params"], "batch_stats": restored["batch_stats"]}
        jcw._save_tree(jvars, str(tmp_path / "vars.npz"))
        enc = tenc.EncoderFreeSplat(tcfg)
        load_flax_variables(enc, tcw.load_tree_npz(str(tmp_path / "vars.npz")))
    else:
        # The port's encoder (seeded), written by the port's keypath writer,
        # read by JAX's reader into the JAX encoder.
        enc = tenc.make_encoder(tcfg, device="cpu", seed=13)
        tcw.save_tree(torch_to_jax_variables(enc), str(tmp_path / "vars.npz"))
        jvars = jcw.load_tree_npz(str(tmp_path / "vars.npz"))
    enc.eval()
    jout = japply(jvars, jctx)
    with torch.no_grad():
        tout = enc(tctx)
    assert_same_outputs(tout, jout)
