"""``ops.table_grad.gather_rows``: the material-table gather whose backward
sums each row's lanes in a fixed order.

On the CPU: its plain backward against autograd's backward of
``table[idx]`` in float64; with no gradient needed it is that op itself;
the fit's program (scene 17) reaches every trainable column through it
alone.  On the card (marker ``cuda``, skipped without one; the file
imports no JAX, so ``python -m pytest --noconftest -m cuda
tests/test_torch_gather_rows.py`` runs there): the kernel against float64
``index_add_``, the same bits on every call and on a graph's replay, and
its launches counted.
"""
import numpy as np
import pytest
import torch

from tpu_pathtracer_torch import parallel as tpar
from tpu_pathtracer_torch.ops import cuda_trace
from tpu_pathtracer_torch.ops import table_grad
from tpu_pathtracer_torch.ops.table_grad import gather_rows
from tpu_pathtracer_torch.render import integrator as tint

# the most material rows of a shipped scene: scenes 7, 12 and 14 (four
# instanced bunnies, each its own material, in the Cornell box)
MAX_SHIPPED_ROWS = 8


def _case(rows, channels, n, seed, dtype=torch.float64, one_row=None):
    g = torch.Generator().manual_seed(seed)
    shape = (rows,) if channels == 1 else (rows, channels)
    table = torch.randn(shape, generator=g, dtype=dtype)
    if one_row is None:
        idx = torch.randint(0, rows, (n,), generator=g)
    else:
        idx = torch.full((n,), one_row, dtype=torch.int64)
    grad = torch.randn((n, *shape[1:]), generator=g, dtype=dtype)
    return table, idx, grad


def _table_grad(fn, table, idx, grad):
    t = table.clone().requires_grad_(True)
    out = fn(t, idx)
    (g,) = torch.autograd.grad(out, t, grad)
    return out.detach(), g


@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("rows", [1, 5, MAX_SHIPPED_ROWS])
@pytest.mark.parametrize("lanes", ["random", "one_row", "empty"])
def test_plain_backward_equals_autograd(rows, channels, lanes):
    """Forward and table gradient equal ``table[idx]``'s in float64: lanes
    spread over every row, all on the last row, and no lanes at all."""
    n = {"random": 1000, "one_row": 257, "empty": 0}[lanes]
    table, idx, grad = _case(rows, channels, n, seed=rows * 10 + channels,
                             one_row=rows - 1 if lanes == "one_row" else None)
    out, got = _table_grad(gather_rows, table, idx, grad)
    ref_out, want = _table_grad(lambda t, i: t[i], table, idx, grad)
    assert torch.equal(out, ref_out)
    assert got.shape == table.shape and got.dtype == torch.float64
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_plain_backward_takes_negative_rows_as_indexing_does():
    table, idx, grad = _case(5, 3, 300, seed=7)
    idx = idx - 5 * (idx % 2)                 # every odd row from the end
    out, got = _table_grad(gather_rows, table, idx, grad)
    ref_out, want = _table_grad(lambda t, i: t[i], table, idx, grad)
    assert torch.equal(out, ref_out)
    torch.testing.assert_close(got, want, rtol=1e-12, atol=1e-12)


def test_no_gradient_needed_is_the_indexing_op():
    """Autograd off, or a table that needs no gradient: ``table[idx]``
    with no node of its own."""
    table, idx, _ = _case(5, 3, 64, seed=3, dtype=torch.float32)
    leaf = table.clone().requires_grad_(True)
    with torch.no_grad():
        off = gather_rows(leaf, idx)
    assert off.grad_fn is None and torch.equal(off, table[idx])
    plain = gather_rows(table, idx)
    assert plain.grad_fn is None and torch.equal(plain, table[idx])
    on = gather_rows(leaf, idx)
    assert type(on.grad_fn).__name__ == "_GatherRowsBackward"


def _nodes(root):
    seen, todo = set(), [root]
    while todo:
        node = todo.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        todo.extend(f for f, _ in node.next_functions)
    return seen


def test_fit_program_reaches_columns_only_through_gather_rows():
    """The autograd graph of ``parallel._loss_program``'s render (scene 17,
    8x8, 1 spp, depth 2, the CPU): every edge into a trainable column
    comes from a ``gather_rows`` node, and every column the render reads
    is reached; no ``IndexBackward0`` reads one."""
    from tpu_pathtracer_torch.scenes import load_scene
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        s, m, c = load_scene(17, 8, 8, table_res=16, device="cpu")
        cfg = tint.RenderConfig(width=8, height=8, spp=1, max_depth=2,
                                precise=True)
        params = {k: v.detach().clone().requires_grad_(True)
                  for k, v in tpar.extract_params(s).items()}
        with torch.enable_grad():
            rgb = tpar._accum_linear(tpar.merge_params(s, params), m, c, cfg,
                                     tint._pixel_grid(8, 8, "cpu"))
    finally:
        torch.set_num_threads(n)
    nodes = _nodes(rgb.grad_fn)
    leaf_of = {id(v): k for k, v in params.items()}
    reached = {}
    for node in nodes:
        for nxt, _ in node.next_functions:
            var = getattr(nxt, "variable", None)
            if var is not None and id(var) in leaf_of:
                reached.setdefault(leaf_of[id(var)], set()).add(
                    type(node).__name__)
    assert set(reached) == set(tpar.TRAINABLE_COLUMNS), reached
    for k, kinds in reached.items():
        assert kinds == {"_GatherRowsBackward"}, (k, kinds)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _kernel_case(rows, channels, n, seed, dev):
    table, idx, grad = _case(rows, channels, n, seed, dtype=torch.float32)
    return idx.to(dev), grad.to(dev), idx, grad


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
@pytest.mark.parametrize("rows,n", [(1, 1), (5, 16384), (5, 1000),
                                    (MAX_SHIPPED_ROWS, 16384),
                                    (MAX_SHIPPED_ROWS, 600_000),
                                    (40, 4097)])
def test_kernel_matches_float64_index_add(dev, rows, channels, n):
    """Each row within 1e-6 of the sum of its lanes' |g|, against float64
    ``index_add_`` (600,000 lanes fill the grid's cap of blocks)."""
    idx, grad, idx_cpu, grad_cpu = _kernel_case(rows, channels, n, n + rows,
                                                dev)
    got = table_grad.gather_rows_grad(grad, idx, rows)
    torch.cuda.synchronize()
    shape = (rows,) if channels == 1 else (rows, channels)
    want = torch.zeros(shape, dtype=torch.float64).index_add_(
        0, idx_cpu, grad_cpu.double())
    scale = torch.zeros(shape, dtype=torch.float64).index_add_(
        0, idx_cpu, grad_cpu.double().abs())
    assert got.shape == shape and got.dtype == torch.float32
    err = (got.cpu().double() - want).abs()
    assert bool((err <= 1e-6 * scale).all()), float((err - 1e-6 * scale).max())


@pytest.mark.cuda
@pytest.mark.parametrize("channels", [1, 3])
def test_kernel_same_bits_every_call(dev, channels):
    idx, grad, _, _ = _kernel_case(5, channels, 16384, 11, dev)
    outs = [table_grad.gather_rows_grad(grad, idx, 5) for _ in range(3)]
    assert all(torch.equal(o, outs[0]) for o in outs[1:])


@pytest.mark.cuda
def test_kernel_negative_rows_and_empty(dev):
    idx, grad, idx_cpu, grad_cpu = _kernel_case(5, 3, 5000, 5, dev)
    neg = idx - 5 * (idx % 2)
    got = table_grad.gather_rows_grad(grad, neg, 5).cpu()
    want = table_grad.gather_rows_grad_plain(grad_cpu, idx_cpu, 5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-6 * float(grad_cpu.abs().sum()))
    empty = table_grad.gather_rows_grad(grad[:0], idx[:0], 5)
    assert torch.equal(empty, torch.zeros(5, 3, device=dev))


@pytest.mark.cuda
def test_kernel_rejects_what_it_does_not_take(dev):
    idx, grad, _, _ = _kernel_case(5, 3, 64, 1, dev)
    with pytest.raises(TypeError):
        table_grad.gather_rows_grad(grad.double(), idx, 5)
    with pytest.raises(ValueError):
        table_grad.gather_rows_grad(torch.zeros(64, 2, device=dev), idx, 5)
    with pytest.raises(ValueError):
        table_grad.gather_rows_grad(grad, idx[:10], 5)


@pytest.mark.cuda
def test_kernel_graph_replay_equals_eager_and_counts(dev):
    """A captured backward of ``gather_rows`` replays to the eager call's
    bits; ``LAUNCHES`` and ``LANES`` count each launch once and each
    replay once (the capture itself counts none)."""
    n = 16384
    idx, grad, _, _ = _kernel_case(5, 3, n, 21, dev)
    table = torch.randn(5, 3, device=dev, requires_grad=True)

    def backward():
        out = gather_rows(table, idx)
        return torch.autograd.grad(out, table, grad)[0]

    cuda_trace.reset_launch_counts()
    eager = backward()
    torch.cuda.synchronize()
    assert cuda_trace.LAUNCHES[table_grad.KERNEL_NAME] == 1
    assert cuda_trace.LANES[table_grad.KERNEL_NAME] == n
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        backward()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    cuda_trace.reset_launch_counts()
    with cuda_trace.captured_launches() as recorded:
        with torch.cuda.graph(graph):
            captured = backward()
    assert not +cuda_trace.LAUNCHES
    assert recorded.launches == {table_grad.KERNEL_NAME: 1}
    for k in range(2):
        captured.zero_()
        graph.replay()
        cuda_trace.count_replay(recorded)
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)
        assert cuda_trace.LAUNCHES[table_grad.KERNEL_NAME] == k + 1
        assert cuda_trace.LANES[table_grad.KERNEL_NAME] == n * (k + 1)
    graph.reset()
