"""pytest settings for the benchmark's own tests (``perfbench/tests``)."""
import pytest
import torch


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "chip: needs a CUDA card; skips without one (run on the card with "
        "`python3 -m pytest perfbench/tests -m chip`)")


@pytest.fixture
def cuda_device():
    """The card, or a skip when this machine has none (decided here, at run time)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return "cuda"


def shrink(cell):
    """``cell`` cut to a size the CPU runs in seconds: 32x64 frames, 8 depth
    planes, 2 target views, a few-splat scene, a 6-view whole scene in
    chunks of 3.  In place; returns the cell."""
    o, tr = cell.config["overrides"], cell.traffic
    o["dataset.image_shape"] = [32, 64]
    o["encoder.num_depth_candidates"] = 8
    tr["gaussians_per_scene"] = 300
    tr["target_views"] = 2
    tr["profile_units"] = 1
    if tr["entry"] == "fit":
        tr["pool_scenes"] = 4
    else:
        tr["context_views"] = 6
        o["test.encode_view_chunk"] = 3
        if tr.get("path") == "walk":  # targets among the six contexts' frames
            tr["target_last_frame"] = tr["context_stride"] * 5
    return cell


@pytest.fixture
def small_cell():
    """``small_cell(name)``: the cell from its files, shrunk (``shrink``)."""
    from perfbench import harness

    return lambda name, **kw: shrink(harness.load_cell(name, **kw))


@pytest.fixture(autouse=True)
def _few_threads():
    """Few torch threads: the tests' small ops run fastest that way, and
    alike from run to run."""
    saved = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(saved)
