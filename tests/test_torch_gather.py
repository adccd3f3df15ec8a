"""``ops/gather.py``: the row gather with a fixed-order gradient, on the CPU.

``take_rows`` against ``index_select`` (forward) and ``index_add_``
(gradient) on numpy-seeded inputs with repeated, empty and out-of-order
indices; its plain segment sum against a direct per-row sum and against
itself across two calls, bit for bit; and ``fit``'s scoped cuDNN flags.
"""
import numpy as np
import pytest
import torch

from freesplat_tpu_torch.ops import gather as G


def _inputs(rows, n, tail, seed):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((rows, *tail)).astype(np.float32))
    # Indices from a few rows only: repeats, rows nothing reads, any order.
    pool = rng.choice(rows, size=max(1, rows // 3), replace=False)
    index = torch.from_numpy(rng.choice(pool, size=n)).long()
    cot = torch.from_numpy(rng.standard_normal((n, *tail)).astype(np.float32))
    return x, index, cot


@pytest.mark.parametrize("rows,n,tail", [(50, 400, (10,)), (7, 60, (3, 4)), (30, 90, ()),
                                         (20, 0, (5,)), (1, 33, (2,))])
def test_take_rows_matches_index_select_and_index_add(rows, n, tail):
    """Forward equal to ``index_select``; gradient equal to ``index_add_``
    (which on the CPU adds in index order, as the segment sum does)."""
    x, index, cot = _inputs(rows, n, tail, seed=rows + n)
    xg = x.clone().requires_grad_(True)
    out = G.take_rows(xg, index)
    torch.testing.assert_close(out, x.index_select(0, index), rtol=0, atol=0)
    (out * cot).sum().backward()
    want = torch.zeros_like(x).index_add_(0, index, cot)
    torch.testing.assert_close(xg.grad, want, rtol=0, atol=0)
    unread = torch.ones(rows, dtype=torch.bool)
    unread[index] = False
    assert (xg.grad[unread] == 0).all()


def test_segment_plan_and_plain_sum():
    """The plan lists each row's entries in index order; the plain sum
    equals a direct left-to-right sum per row and is bit-equal across two
    calls."""
    x, index, cot = _inputs(40, 500, (6,), seed=3)
    order, offsets = G.segment_plan(index, 40)
    assert offsets[0] == 0 and offsets[-1] == len(index)
    for r in range(40):
        seg = order[offsets[r]:offsets[r + 1]]
        assert (index[seg] == r).all() and (seg[1:] > seg[:-1]).all()
    a = G.segment_sum_plain(cot, order, offsets, 40)
    b = G.segment_sum_plain(cot.clone(), order.clone(), offsets.clone(), 40)
    assert torch.equal(a, b)
    for r in range(40):
        acc = torch.zeros(6)
        for k in order[offsets[r]:offsets[r + 1]]:
            acc = acc + cot[k]
        assert torch.equal(a[r], acc)
    # The CPU wrapper takes the plain version and launches nothing.
    before = dict(G.launch_count)
    assert torch.equal(G.segment_sum(cot, order, offsets, 40), a)
    assert G.launch_count == before


def test_take_rows_without_grad_is_index_select():
    """Without a gradient ``take_rows`` is plain ``index_select``: no
    autograd node, the same values; with one, its own backward."""
    x, index, cot = _inputs(12, 30, (4,), seed=5)
    with torch.no_grad():
        out = G.take_rows(x.requires_grad_(True), index)
    assert out.grad_fn is None and torch.equal(out, x.detach().index_select(0, index))
    assert "TakeRows" in type(G.take_rows(x, index).grad_fn).__name__


def test_fit_holds_cudnn_deterministic_only_inside(monkeypatch):
    """``fit`` runs its steps under ``deterministic_cudnn`` and restores
    the process's cuDNN flags when it returns, also when a step raises."""
    from freesplat_tpu_torch.training import trainer as ttr

    seen = []

    def fake_make_train_step(cfg, lpips=None):
        def step(state, batch, timings=None):
            seen.append((torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark))
            if batch == "raise":
                raise RuntimeError("step failed")
            return {**state, "step": state["step"] + 1}, {"loss": torch.tensor(0.0)}
        return step

    monkeypatch.setattr(ttr, "make_train_step", fake_make_train_step)
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", False)
    monkeypatch.setattr(torch.backends.cudnn, "benchmark", True)
    ttr.fit(ttr.TrainCfg(), {"step": 0}, iter(range(3)), max_steps=3)
    assert seen == [(True, False)] * 3
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (False, True)
    with pytest.raises(RuntimeError, match="step failed"):
        ttr.fit(ttr.TrainCfg(), {"step": 0}, iter(["raise"]), max_steps=1)
    assert (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark) == (False, True)
