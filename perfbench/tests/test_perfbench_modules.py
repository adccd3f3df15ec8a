"""The check for JAX by whole top-level module name, and the reference's
own imports."""
import subprocess
import sys

from perfbench import harness


def test_forbidden_names_compare_whole():
    assert harness.forbidden_loaded({"jax.numpy": 0, "numpy": 0}) == ["jax"]
    assert harness.forbidden_loaded({"freesplat_tpu.ops.rasterizer": 0}) == ["freesplat_tpu"]
    assert harness.forbidden_loaded({"freesplat_tpu_torch.ops": 0, "jaxtyping": 0,
                                     "flaxen": 0, "torch": 0}) == []
    assert harness.forbidden_loaded({"flax.linen": 0, "optax": 0, "jaxlib.xla": 0}) == [
        "flax", "jaxlib", "optax"]


def _loaded_after(code: str) -> set[str]:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys\nprint(' '.join(sorted({m.split('.')[0] "
         "for m in sys.modules})))"],
        cwd=harness.ROOT, capture_output=True, text=True, timeout=300, check=True)
    return set(out.stdout.split())


def test_reference_imports_nothing_of_the_program():
    tops = _loaded_after("import perfbench.reference.model, perfbench.reference.render, "
                         "perfbench.reference.lpips, perfbench.reference.steps")
    assert not tops & {"freesplat_tpu_torch", "freesplat_tpu", "jax", "jaxlib", "flax", "optax"}


def test_harness_and_program_load_no_jax():
    tops = _loaded_after("import perfbench.run, perfbench.calibrate\n"
                         "import freesplat_tpu_torch.training.trainer, "
                         "freesplat_tpu_torch.evaluation.harness")
    assert "freesplat_tpu_torch" in tops
    assert not tops & set(harness.FORBIDDEN_MODULES)


def test_alone_without_the_program_fails(tmp_path):
    """In a directory that holds only BENCHMARK.json and perfbench/, a run
    exits non-zero and prints no result."""
    import shutil

    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH_DIR, tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", "scannet2v-train", "--seed", "1",
         "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
        timeout=300)
    assert out.returncode != 0 and "{" not in out.stdout
