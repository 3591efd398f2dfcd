"""The port's CUDA kernels against their plain PyTorch versions, on the
card.  Every test needs an NVIDIA GPU and skips without one; this file
imports no JAX, so it runs on a GPU host as it is:

    python -m pytest tests/test_torch_kernels_gpu.py -q

Tolerances: f32 outputs within 1e-4 and bf16 within 2e-2 (compared as
f32; both sides accumulate in f32, in different orders); the LSE
within 1e-3; flash-backward gradients within the same 1e-4 / 2e-2 of
the plain version's largest |value|; greedy tokens equal.  The
observability plane is checked for what it must not do (add device
work) on identical inputs in the caller's thread, and its four routes
for their payloads; no check compares times.
"""
from __future__ import annotations

import json
import urllib.request

import pytest
import torch

from skypilot_tpu_torch.models import configs
from skypilot_tpu_torch.models import convert
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.models.transformer import init_params
from skypilot_tpu_torch.observability import metrics
from skypilot_tpu_torch.observability import profiling
from skypilot_tpu_torch.ops import attention
from skypilot_tpu_torch.ops import paged_attention
from skypilot_tpu_torch.serve import async_server
from skypilot_tpu_torch.serve import batching_engine
from skypilot_tpu_torch.serve import http_protocol
from skypilot_tpu_torch.serve import model_server
from skypilot_tpu_torch.serve import plane_check

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs an NVIDIA GPU: the CUDA kernels have no CPU mode')
    return torch.device('cuda', 0)


def _tol(dtype):
    return 1e-4 if dtype == torch.float32 else 2e-2


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,h_kv,d,q_len,k_len,causal', [
    (32, 8, 128, 1, 1, True), (32, 8, 128, 100, 100, True),
    (32, 8, 128, 64, 200, True), (32, 8, 128, 130, 130, False),
    (8, 1, 256, 70, 70, True), (4, 2, 64, 33, 90, True),
    (32, 8, 128, 2048, 2048, True), (16, 8, 64, 512, 512, True),
    (32, 8, 128, 2048, 2048, False)])
def test_flash_kernel_matches_plain(cuda, dtype, h, h_kv, d, q_len, k_len,
                                    causal):
    gen = torch.Generator(device=cuda).manual_seed(q_len * 7 + d)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(dtype)
               for shape in ((2, h, q_len, d), (2, h_kv, k_len, d),
                             (2, h_kv, k_len, d)))
    before = attention.LAUNCHES['flash_fwd']
    out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
    assert attention.LAUNCHES['flash_fwd'] == before + 1
    ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=causal, sm_scale=d ** -0.5, return_lse=True)
    torch.cuda.synchronize()
    assert out.dtype == dtype and lse.dtype == torch.float32
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)


def test_flash_rows_do_not_depend_on_q_len_or_batch(cuda):
    """The bf16 tensor-core forward gives a query row the same bits in a
    512-token chunk, as one of the last 100 rows against the same keys
    (another q-tile, another place in it) and without the other batch
    row: the k-tile width and order are fixed, and a fully masked k-tile
    adds exact zeros."""
    gen = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda)
               .to(torch.bfloat16)
               for shape in ((2, 32, 512, 128), (2, 8, 512, 128),
                             (2, 8, 512, 128)))
    out, lse = attention.flash_attention_with_lse(q, k, v)
    tail, tail_lse = attention.flash_attention_with_lse(
        q[:, :, 412:].contiguous(), k, v)
    one, one_lse = attention.flash_attention_with_lse(
        q[1:].contiguous(), k[1:].contiguous(), v[1:].contiguous())
    torch.cuda.synchronize()
    assert torch.equal(out[:, :, 412:], tail)
    assert torch.equal(lse[:, :, 412:], tail_lse)
    assert torch.equal(out[1:], one) and torch.equal(lse[1:], one_lse)


def _bwd_inputs(dev, dtype, h, h_kv, d, q_len, k_len, causal, seed):
    gen = torch.Generator(device=dev).manual_seed(seed)
    q, k, v, g = (torch.randn(shape, generator=gen, device=dev).to(dtype)
                  for shape in ((2, h, q_len, d), (2, h_kv, k_len, d),
                                (2, h_kv, k_len, d), (2, h, q_len, d)))
    g_lse = torch.randn((2, h, q_len), generator=gen, device=dev)
    out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
    return q, k, v, out, lse, g, g_lse


def _assert_copies_on_their_cards(state, placements, devices):
    """Each block has one copy on each distinct card among the mesh
    positions that hold it, first holder first: one copy a block on a
    list that repeats one card."""
    for name, copies in state.shards.copies.items():
        holders = placements[name].holders(len(state.shards.shapes[name]))
        for blk, held in copies.items():
            want = list(dict.fromkeys(devices[p] for p in holders[blk]))
            assert list(held) == want, name
            assert [t.device for t in held.values()] == want, name
            if len(set(devices)) == 1:
                assert len(held) == 1, name


def _assert_rel_close(got, ref, tol, what):
    scale = ref.float().abs().max().clamp(min=1e-30)
    err = (got.float() - ref.float()).abs().max() / scale
    assert torch.isfinite(got.float()).all(), what
    assert err <= tol, f'{what}: max err {float(err):.3g} of max |ref|'


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('h,h_kv,d,q_len,k_len,causal', [
    (32, 8, 128, 2048, 2048, True),
    (32, 8, 128, 100, 100, True), (32, 8, 128, 1000, 1000, True),
    (32, 8, 128, 100, 612, True), (32, 8, 128, 130, 130, False),
    (28, 4, 128, 130, 130, True), (8, 1, 256, 70, 70, True),
    (4, 2, 64, 33, 90, True)])
def test_flash_bwd_kernels_match_plain(cuda, dtype, h, h_kv, d, q_len,
                                       k_len, causal):
    """B4 (dQ) and B5 (dK/dV) against _flash_bwd_reference on the same
    inputs, with a non-zero LSE cotangent; two launches give the same
    bits (no atomics)."""
    args = _bwd_inputs(cuda, dtype, h, h_kv, d, q_len, k_len, causal,
                       seed=q_len + d + h)
    before = dict(attention.LAUNCHES)
    got = attention._flash_bwd_cuda(*args, causal=causal,  # pylint: disable=protected-access
                                    sm_scale=d ** -0.5)
    again = attention._flash_bwd_cuda(*args, causal=causal,  # pylint: disable=protected-access
                                      sm_scale=d ** -0.5)
    for name in ('flash_bwd_dq', 'flash_bwd_dkv'):
        assert attention.LAUNCHES[name] == before[name] + 2
    ref = attention._flash_bwd_reference(*args, causal=causal,  # pylint: disable=protected-access
                                         sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    for name, a, b, r in zip(('dq', 'dk', 'dv'), got, again, ref):
        assert a.dtype == dtype and a.shape == r.shape
        assert torch.equal(a, b), f'{name}: launches differ'
        _assert_rel_close(a, r, _tol(dtype), name)


def test_flash_autograd_matches_autograd_of_plain(cuda):
    """_FlashLSE on CUDA (B3 forward, B4/B5 backward) against autograd
    through the plain forward, through both outputs."""
    gen = torch.Generator(device=cuda).manual_seed(4)
    shapes = ((2, 8, 77, 64), (2, 2, 77, 64), (2, 2, 77, 64))
    leaves = [torch.randn(s, generator=gen, device=cuda) for s in shapes]
    g = torch.randn(shapes[0], generator=gen, device=cuda)
    g_lse = torch.randn(shapes[0][:3], generator=gen, device=cuda)
    grads = []
    for fn in (attention.flash_attention_with_lse,
               lambda q, k, v: attention._blockwise_attention(  # pylint: disable=protected-access
                   q, k, v, causal=True, sm_scale=64 ** -0.5,
                   return_lse=True)):
        q, k, v = (t.clone().requires_grad_() for t in leaves)
        out, lse = fn(q, k, v)
        ((out * g).sum() + (lse * g_lse).sum()).backward()
        grads.append((q.grad, k.grad, v.grad))
    for name, a, r in zip(('dq', 'dk', 'dv'), *grads):
        _assert_rel_close(a, r, 1e-4, name)


def _pool(gen, n_pages, h_kv, ps, d, dtype, quantized, dev):
    k = torch.randn((n_pages, h_kv, ps, d), generator=gen, device=dev)
    v = torch.randn((n_pages, h_kv, ps, d), generator=gen, device=dev)
    if not quantized:
        return k.to(dtype), v.to(dtype)
    (kq, ks), (vq, vs) = decode._quant_kv(k), decode._quant_kv(v)  # pylint: disable=protected-access
    return {'q': kq, 'scale': ks}, {'q': vq, 'scale': vs}


def _paged_tables(lengths, s_q, ps, rows, seed):
    """Tables naming distinct pages for each slot (unused entries the
    null page 0), and the lengths as int32 (both on the CPU)."""
    tables = torch.zeros((len(lengths), rows), dtype=torch.int32)
    perm = torch.randperm(len(lengths) * rows,
                          generator=torch.Generator().manual_seed(seed)) + 1
    for i, n in enumerate(lengths):
        need = -(-(n + s_q) // ps)
        tables[i, :need] = perm[i * rows:i * rows + need].to(torch.int32)
    return tables, torch.tensor(lengths, dtype=torch.int32)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('quantized', [False, True], ids=['native', 'int8'])
@pytest.mark.parametrize('s_q', [1, 5])
@pytest.mark.parametrize('h_q,h_kv,d', [(32, 8, 128), (8, 1, 256),
                                        (16, 8, 64)])
@pytest.mark.parametrize('lengths', [[1, 15, 16, 17, 200],
                                     [1000, 999, 63, 64]],
                         ids=['ragged', 'long'])
def test_paged_kernel_matches_plain(cuda, dtype, quantized, s_q, h_q, h_kv,
                                    d, lengths):
    """Ragged lengths and long contexts (at 1000 positions B1 and B2
    spread a slot over 16 splits of 4 pages, merged by the last block);
    two launches give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(s_q + d)
    b, ps = len(lengths), 16
    rows = max(16, -(-(max(lengths) + s_q) // ps))
    k, v = _pool(gen, 1 + b * rows, h_kv, ps, d, dtype, quantized, cuda)
    q = torch.randn((b, h_q, s_q, d), generator=gen, device=cuda).to(dtype)
    tables, lengths = _paged_tables(lengths, s_q, ps, rows, d)
    tables[0, 0] = 0                     # the null page as a live row
    tables, lengths = tables.to(cuda), lengths.to(cuda)
    name = 'paged_attention_int8' if quantized else 'paged_attention'
    before = paged_attention.LAUNCHES[name]
    out = paged_attention.paged_attention(q, k, v, tables, lengths)
    again = paged_attention.paged_attention(q, k, v, tables, lengths)
    assert paged_attention.LAUNCHES[name] == before + 2
    ref = paged_attention._paged_attention_reference(  # pylint: disable=protected-access
        q, k, v, tables, lengths, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('quantized', [False, True], ids=['native', 'int8'])
def test_paged_kernel_at_the_slice_tick(cuda, dtype, quantized):
    """The slice engine's tick at llama3-8b's width: 4 slots of an
    8192-token engine (512-row tables, 128 splits a slot) holding
    contexts up to 7930 and a free slot, S = 1."""
    gen = torch.Generator(device=cuda).manual_seed(7930)
    lengths, ps, rows, h_q, h_kv, d = [3030, 7930, 130, 0], 16, 512, 32, 8, 128
    k, v = _pool(gen, 1 + len(lengths) * rows, h_kv, ps, d, dtype,
                 quantized, cuda)
    q = torch.randn((len(lengths), h_q, 1, d), generator=gen,
                    device=cuda).to(dtype)
    tables, lengths = _paged_tables(lengths, 1, ps, rows, d)
    tables, lengths = tables.to(cuda), lengths.to(cuda)
    out = paged_attention.paged_attention(q, k, v, tables, lengths)
    again = paged_attention.paged_attention(q, k, v, tables, lengths)
    ref = paged_attention._paged_attention_reference(  # pylint: disable=protected-access
        q, k, v, tables, lengths, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=_tol(dtype),
                               rtol=_tol(dtype))


@pytest.mark.parametrize('quantized', [False, True], ids=['native', 'int8'])
def test_paged_rows_do_not_depend_on_s_or_batch(cuda, quantized):
    """A query row's bits do not depend on S, R, B or the other slots:
    the row at qpos of an S = 5 call with lengths qpos - j equals the
    S = 1 call with lengths qpos (the S = 5 call may reach a split that
    is wholly masked for the row: 255 + 5 crosses the 256-position
    boundary of 4 pages of 16), and a slot alone equals the same slot
    among five."""
    gen = torch.Generator(device=cuda).manual_seed(23)
    h_q, h_kv, d, ps, rows = 32, 8, 128, 16, 64
    qpos = [1000, 17, 63, 255, 300]
    b = len(qpos)
    k, v = _pool(gen, 1 + b * rows, h_kv, ps, d, torch.bfloat16, quantized,
                 cuda)
    tables, _ = _paged_tables(qpos, 5, ps, rows, 4)
    tables = tables.to(cuda)
    q1 = torch.randn((b, h_q, 1, d), generator=gen,
                     device=cuda).to(torch.bfloat16)
    lengths = torch.tensor(qpos, dtype=torch.int32, device=cuda)
    one = paged_attention.paged_attention(q1, k, v, tables, lengths)
    q5 = q1.expand(-1, -1, 5, -1).contiguous()
    for j in range(5):
        five = paged_attention.paged_attention(q5, k, v, tables, lengths - j)
        assert torch.equal(five[:, :, j], one[:, :, 0]), j
    for i in range(b):
        alone = paged_attention.paged_attention(
            q1[i:i + 1].contiguous(), k, v, tables[i:i + 1].contiguous(),
            lengths[i:i + 1].contiguous())
        assert torch.equal(alone[0], one[i]), i


def test_paged_tickets_stay_zero_across_kernels_and_batches(cuda):
    """B1 and B2 share the wrapper's ticket counters.  Launched in turn
    on one stream at 2 and 8 slots (a B1 launch after a larger B2 launch
    and before one), every launch leaves every counter at 0, and each B1
    output equals, bit for bit, a fresh B1 launch's on the same inputs."""
    gen = torch.Generator(device=cuda).manual_seed(31)
    h_q, h_kv, d, ps, rows = 32, 8, 128, 16, 64
    cases = {}
    for b in (2, 8):
        lengths = [1000 - 37 * i for i in range(b)]
        for quantized, s_q in ((False, 1), (True, 5)):
            k, v = _pool(gen, 1 + b * rows, h_kv, ps, d, torch.bfloat16,
                         quantized, cuda)
            q = torch.randn((b, h_q, s_q, d), generator=gen,
                            device=cuda).to(torch.bfloat16)
            tables, lens = _paged_tables(lengths, s_q, ps, rows, b)
            cases[b, quantized] = (q, k, v, tables.to(cuda), lens.to(cuda))
    fresh = {b: paged_attention.paged_attention(*cases[b, False])
             for b in (2, 8)}
    for b, quantized in ((8, True), (2, False), (2, True), (8, False),
                         (8, True), (2, False), (8, False)):
        out = paged_attention.paged_attention(*cases[b, quantized])
        torch.cuda.synchronize()
        tickets = paged_attention._TICKETS[  # pylint: disable=protected-access
            cuda, torch.cuda.current_stream(cuda).cuda_stream]
        assert int(tickets.count_nonzero()) == 0, (b, quantized)
        if not quantized:
            assert torch.equal(out, fresh[b]), b


def test_paged_launches_on_two_streams_match_one_stream(cuda):
    """B1 (2 slots) and B2 (8 slots) launched in turn on two streams at
    once, ten rounds: every output equals, bit for bit, a launch on the
    current stream alone; each stream counts in its own tickets, and
    every counter reads 0 after synchronising."""
    gen = torch.Generator(device=cuda).manual_seed(41)
    h_q, h_kv, d, ps, rows = 32, 8, 128, 16, 64
    cases = []
    for b, quantized, s_q in ((2, False, 1), (8, True, 5)):
        lengths = [1000 - 53 * i for i in range(b)]
        k, v = _pool(gen, 1 + b * rows, h_kv, ps, d, torch.bfloat16,
                     quantized, cuda)
        q = torch.randn((b, h_q, s_q, d), generator=gen,
                        device=cuda).to(torch.bfloat16)
        tables, lens = _paged_tables(lengths, s_q, ps, rows, b)
        cases.append((q, k, v, tables.to(cuda), lens.to(cuda)))
    alone = [paged_attention.paged_attention(*case) for case in cases]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(cuda), torch.cuda.Stream(cuda)]
    for stream in streams:
        stream.wait_stream(torch.cuda.current_stream(cuda))
    outs = [[], []]
    for _ in range(10):
        for i, (stream, case) in enumerate(zip(streams, cases)):
            with torch.cuda.stream(stream):
                outs[i].append(paged_attention.paged_attention(*case))
    torch.cuda.synchronize()
    for i in range(2):
        for out in outs[i]:
            assert torch.equal(out, alone[i]), i
    tickets = paged_attention._TICKETS  # pylint: disable=protected-access
    mine = [tickets[cuda, s.cuda_stream] for s in streams]
    assert mine[0].data_ptr() != mine[1].data_ptr()
    for key, counters in tickets.items():
        assert int(counters.count_nonzero()) == 0, key


@pytest.mark.parametrize('h,h_kv,d', [(16, 8, 64), (32, 8, 128),
                                      (8, 1, 256)])
def test_flash_bwd_dq_wgmma_is_deterministic(cuda, h, h_kv, d):
    """The bf16 dQ kernel (B4) at each head_dim, q 100 < k 612 (the
    diagonal at pos_offset 512, a ragged last q-tile and k-tile): two
    launches give the same bits, within 2e-2 of the plain dQ's largest
    |value|."""
    q, k, v, out, lse, g, g_lse = _bwd_inputs(
        cuda, torch.bfloat16, h, h_kv, d, 100, 612, True, seed=d)
    delta = attention._delta(out, g, g_lse).contiguous()  # pylint: disable=protected-access
    kw = dict(causal=True, sm_scale=d ** -0.5)
    before = attention.LAUNCHES['flash_bwd_dq']
    dq = attention._flash_bwd_dq_cuda(q, k, v, g, lse, delta, **kw)  # pylint: disable=protected-access
    again = attention._flash_bwd_dq_cuda(q, k, v, g, lse, delta, **kw)  # pylint: disable=protected-access
    assert attention.LAUNCHES['flash_bwd_dq'] == before + 2
    ref = attention._flash_bwd_reference(q, k, v, out, lse, g, g_lse, **kw)  # pylint: disable=protected-access
    torch.cuda.synchronize()
    assert torch.equal(dq, again)
    _assert_rel_close(dq, ref[0], 2e-2, 'dq')


def test_wrappers_raise_instead_of_falling_back(cuda):
    q = torch.randn((1, 4, 8, 128), device=cuda)
    k = torch.randn((1, 2, 8, 128), device=cuda)
    with pytest.raises(ValueError, match='contiguous'):
        attention.flash_attention(
            torch.randn((1, 8, 4, 128), device=cuda).transpose(1, 2), k, k)
    with pytest.raises(ValueError, match='head_dim'):
        attention.flash_attention(q[..., :96].contiguous(),
                                  k[..., :96].contiguous(),
                                  k[..., :96].contiguous())
    with pytest.raises(ValueError, match='dtype'):
        attention.flash_attention(q, k.bfloat16(), k)
    out, lse = attention.flash_attention_with_lse(q, k, k)
    with pytest.raises(ValueError, match='lse'):
        attention._flash_bwd_cuda(q, k, k, out, lse.double(), out, None,  # pylint: disable=protected-access
                                  causal=True, sm_scale=1.0)
    with pytest.raises(ValueError, match='contiguous'):
        attention._flash_bwd_cuda(  # pylint: disable=protected-access
            q, k, k, out, lse, out.transpose(2, 3).contiguous()
            .transpose(2, 3), None, causal=True, sm_scale=1.0)
    pool = torch.zeros((4, 2, 16, 128), device=cuda)
    tables = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    lengths = torch.zeros((1,), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match='int32'):
        paged_attention.paged_attention(q[:, :, :1].contiguous(), pool,
                                        pool, tables.long(), lengths)
    with pytest.raises(ValueError, match='dtype'):
        paged_attention.paged_attention(q[:, :, :1].contiguous(),
                                        pool.bfloat16(), pool.bfloat16(),
                                        tables, lengths)


@pytest.mark.parametrize('sp', [2, 4])
@pytest.mark.parametrize('op', ['ring', 'ulysses'])
def test_sp_attention_on_a_repeated_card_matches_plain(cuda, op, sp):
    """Ring and Ulysses attention over sp ranks that all name cuda:0,
    bf16 at 32/8 heads, d 128: within 2e-2 of the plain causal
    attention of the whole sequence; the ring launches B3 sp (sp + 1) / 2
    times, Ulysses once per rank."""
    from skypilot_tpu_torch.ops import ring_attention
    from skypilot_tpu_torch.ops import ulysses_attention
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    gen = torch.Generator(device=cuda).manual_seed(sp)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((1, 32, 1024, 128), (1, 8, 1024, 128),
                                      (1, 8, 1024, 128)))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=sp), [cuda] * sp)
    fn = (ring_attention.ring_attention if op == 'ring'
          else ulysses_attention.ulysses_attention)
    before = attention.LAUNCHES['flash_fwd']
    out = fn(q, k, v, mesh=mesh)
    launched = attention.LAUNCHES['flash_fwd'] - before
    ref = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=True, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    assert launched == (sp * (sp + 1) // 2 if op == 'ring' else sp)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize('h,h_kv,n,causal', [
    (32, 8, 2048, False), (32, 8, 2048, True), (16, 4, 4096, True)],
    ids=['ring-hop', 'ring-diagonal', 'ulysses'])
def test_flash_kernels_at_the_sharded_training_shapes(cuda, h, h_kv, n,
                                                      causal):
    """B3-B5 at the shapes sharded training gives them at llama3-8b
    width, batch 2 x 4096 (bf16, b 1, d 128): mesh A's ring hop (fsdp 2
    x sequence 2: 2048 x 2048, non-causal on the earlier chunk, causal on
    the diagonal) and mesh B's Ulysses call (data 2 x sequence 2: 16/4
    heads over 4096).  The forward and its lse against the plain
    version; dQ and dK/dV with a non-zero lse cotangent (what the ring's
    merge feeds each hop) against _flash_bwd_reference; two launches
    give the same bits."""
    gen = torch.Generator(device=cuda).manual_seed(n + h + causal)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((1, h, n, 128), (1, h_kv, n, 128),
                                      (1, h_kv, n, 128), (1, h, n, 128)))
    g_lse = torch.randn((1, h, n), generator=gen, device=cuda)
    kw = dict(causal=causal, sm_scale=128 ** -0.5)
    out, lse = attention.flash_attention_with_lse(q, k, v, causal=causal)
    out2, lse2 = attention.flash_attention_with_lse(q, k, v, causal=causal)
    ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, return_lse=True, **kw)
    got = attention._flash_bwd_cuda(q, k, v, out, lse, g, g_lse, **kw)  # pylint: disable=protected-access
    again = attention._flash_bwd_cuda(q, k, v, out, lse, g, g_lse, **kw)  # pylint: disable=protected-access
    want = attention._flash_bwd_reference(q, k, v, out, lse, g, g_lse, **kw)  # pylint: disable=protected-access
    torch.cuda.synchronize()
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)
    torch.testing.assert_close(lse, ref_lse, atol=1e-3, rtol=1e-3)
    for name, a, b, r in zip(('dq', 'dk', 'dv'), got, again, want):
        assert torch.equal(a, b), f'{name}: launches differ'
        _assert_rel_close(a, r, 2e-2, name)


@pytest.mark.parametrize('sp', [2, 4])
@pytest.mark.parametrize('op', ['ring', 'ulysses'])
def test_sp_attention_gradients_on_a_repeated_card(cuda, op, sp):
    """The backward through ring and Ulysses attention over sp ranks on
    cuda:0 (B3 forward hops, B4/B5 per hop with the merge's lse
    cotangent), bf16 32/8 heads, d 128, 1024 tokens: dq/dk/dv within
    2e-2 of the largest |value| of autograd through the plain causal
    attention of the whole sequence, from the same upstream gradient.
    The ring launches B4 and B5 once per hop it runs: sp (sp + 1) / 2."""
    from skypilot_tpu_torch.ops import ring_attention
    from skypilot_tpu_torch.ops import ulysses_attention
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    gen = torch.Generator(device=cuda).manual_seed(10 + sp)
    q, k, v, g = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((1, 32, 1024, 128), (1, 8, 1024, 128),
                                      (1, 8, 1024, 128), (1, 32, 1024, 128)))
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(sequence=sp), [cuda] * sp)
    fn = (ring_attention.ring_attention if op == 'ring'
          else ulysses_attention.ulysses_attention)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    before = dict(attention.LAUNCHES)
    got = torch.autograd.grad(fn(*leaves, mesh=mesh), leaves, g)
    launched = attention.LAUNCHES['flash_bwd_dq'] - before['flash_bwd_dq']
    plain = [t.float().clone().requires_grad_() for t in (q, k, v)]
    ref_out = attention._blockwise_attention(  # pylint: disable=protected-access
        *plain, causal=True, sm_scale=128 ** -0.5)
    want = torch.autograd.grad(ref_out, plain, g.float())
    torch.cuda.synchronize()
    assert launched == (sp * (sp + 1) // 2 if op == 'ring' else sp)
    for name, a, r in zip(('dq', 'dk', 'dv'), got, want):
        _assert_rel_close(a, r, 2e-2, name)


@pytest.mark.parametrize('cards', ['one', 'four'])
@pytest.mark.parametrize('axes,mode', [
    ({'fsdp': 2, 'sequence': 2}, 'ring'),
    ({'data': 2, 'sequence': 2}, 'ulysses'),
    ({'sequence': 2, 'tensor': 2}, 'ring')], ids=['fsdp2-seq2-ring',
                                                  'data2-seq2-ulysses',
                                                  'seq2-tensor2-ring'])
def test_sharded_step_matches_unsharded(cuda, axes, mode, cards):
    """Two sharded steps over four mesh positions, all on cuda:0 ('one')
    or one on each of four cards ('four', skipped with fewer), against
    the unsharded step on cuda:0 from the same seed, f32 at llama3-8b
    head shapes cut narrow (d_model 512, 4/2 heads of 128, 2 layers,
    vocab 1024; tensor 2 splits them 2/1 a rank), batch 4 x 256: loss
    and grad_norm within rtol 1e-5,
    every parameter after 2 steps within 2 * lr * steps (Adam's noise
    bound of tests/test_torch_train.py); the kernels launched as
    `chip_smoke.shard_launches` counts them; a copy of each block on
    every distinct card that holds it (one on cuda:0 for 'one'), all
    bit-equal after the steps, and on four cards the same state bytes
    on each card."""
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    if cards == 'four' and torch.cuda.device_count() < 4:
        pytest.skip('needs four NVIDIA GPUs')
    devices = ([cuda] * 4 if cards == 'one' else
               [torch.device('cuda', i) for i in range(4)])
    cfg = configs.get_config('tiny', d_model=512, n_heads=4, n_kv_heads=2,
                             d_ff=1024, vocab_size=1024,
                             max_seq_len=512, sequence_parallel=mode,
                             remat=True)
    gen = torch.Generator().manual_seed(3)
    batch = {'tokens': torch.randint(0, 1024, (4, 257), generator=gen
                                     ).to(cuda)}
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(**axes), devices)
    sharded, placements = train.create_train_state(cfg, mesh=mesh, seed=2)
    _assert_copies_on_their_cards(sharded, placements, devices)
    plain, _ = train.create_train_state(cfg, device=cuda, seed=2)
    before = dict(attention.LAUNCHES)
    for _ in range(2):
        _, m = train.train_step(sharded, batch)
        _, want = train.train_step(plain, batch)
        for key in ('loss', 'grad_norm'):
            torch.testing.assert_close(m[key].to(cuda), want[key],
                                       rtol=1e-5, atol=0)
    ranks = axes.get('data', 1) * axes.get('fsdp', 1)
    hops = 3 if mode == 'ring' else 2
    tp = axes.get('tensor', 1)
    assert (attention.LAUNCHES['flash_bwd_dkv'] - before['flash_bwd_dkv'] ==
            2 * (ranks * tp * 2 * hops + 2))
    for name, p in plain.model.named_parameters():
        torch.testing.assert_close(
            sharded.shards.gather(name, cuda), p, rtol=0,
            atol=2 * train.TrainConfig().learning_rate * 2, msg=name)
    copies = train.check_copies(sharded)
    if cards == 'one':
        assert copies == 0
    else:
        assert copies > 0
        assert len(set(sharded.shards.device_bytes())) == 1


def test_prefill_sp_on_the_card_matches_prefill(cuda):
    """prefill_sp over 4 ranks on cuda:0, llama3-8b width cut to depth
    2, a 1024-token prompt: sp 1 gives prefill's cache bit for bit (one
    causal hop, the same row shapes); sp 4 within 2e-2 of its largest
    |value| per leaf (bf16; other GEMM row counts and the ring's
    merge)."""
    from skypilot_tpu_torch.serve import slice_replica
    cfg = configs.get_config('llama3-8b', n_layers=2)
    model = init_params(cfg, seed=5, device=cuda)
    gen = torch.Generator().manual_seed(0)
    tokens = torch.randint(1, cfg.vocab_size, (1, 1024), generator=gen,
                           dtype=torch.int32).to(cuda)
    _, want = decode.prefill(cfg, model, tokens, max_len=1088)
    for sp in (1, 4):
        mesh = slice_replica.build_slice_mesh(sp, cfg, sequence=sp,
                                              devices=[cuda] * sp)
        got = decode.prefill_sp(cfg, model, tokens, mesh=mesh,
                                max_len=1088)
        assert got['index'] == 1024
        for leaf in ('k', 'v'):
            if sp == 1:
                assert torch.equal(got[leaf], want[leaf]), leaf
            else:
                err = (got[leaf].float() - want[leaf].float()).abs().max()
                assert float(err) <= 2e-2 * float(
                    want[leaf].float().abs().max()), (leaf, float(err))


SMALL = configs.ModelConfig(vocab_size=512, d_model=256, n_layers=2,
                            n_heads=4, n_kv_heads=2, d_ff=512,
                            max_seq_len=256, dtype=torch.float32)
PROMPTS = ([3, 1, 4, 1, 5, 9, 2, 6], [7], list(range(5, 40)))


@pytest.mark.parametrize('quantize_kv,spec_tokens,slots,kv_pages', [
    (False, 0, 2, 24), (True, 0, 2, 24), (True, 3, 2, 24),
    (True, 4, 16, 24), (False, 0, 2, None)],
    ids=['paged', 'int8', 'int8-spec', 'int8-spec-16slots', 'dense'])
def test_engine_gpu_matches_cpu(cuda, quantize_kv, spec_tokens, slots,
                                kv_pages):
    """GPU greedy tokens equal the CPU's; at 16 slots and k = 4 the
    verify tick has 80 rows, past one 64-row bucket (decode's row
    blocks)."""
    gpu_model = init_params(SMALL, seed=2, device=cuda)
    cpu_model = convert.from_jax_params(
        SMALL, convert.to_jax_params(gpu_model), device='cpu')
    out = {}
    for model in (gpu_model, cpu_model):
        engine = batching_engine.ContinuousBatchingEngine(
            SMALL, model, max_len=64, slots=slots, prefill_chunk=16,
            kv_pages=kv_pages, page_size=16, quantize_kv=quantize_kv,
            spec_tokens=spec_tokens if model is gpu_model else 0,
            device=model.device)
        try:
            out[model.device.type] = [engine.generate(p, 10)
                                      for p in PROMPTS]
        finally:
            engine.stop()
    assert out['cuda'] == out['cpu']


@pytest.mark.parametrize('kv_pages', [24, None], ids=['paged', 'dense'])
def test_engine_under_decode_budget_gpu_matches_cpu(cuda, kv_pages):
    """Under the decode role's budget every prefill piece is one token
    (chunk 0 through B3 at the 16 bucket, then width-1 continuations):
    the card gives the CPU's greedy tokens, and they equal the unclamped
    engine's."""
    gpu_model = init_params(SMALL, seed=2, device=cuda)
    cpu_model = convert.from_jax_params(
        SMALL, convert.to_jax_params(gpu_model), device='cpu')
    out = {}
    for name, model, clamped in (('cuda', gpu_model, True),
                                 ('cpu', cpu_model, True),
                                 ('cpu unclamped', cpu_model, False)):
        engine = batching_engine.ContinuousBatchingEngine(
            SMALL, model, max_len=64, slots=2, prefill_chunk=16,
            kv_pages=kv_pages, page_size=16, device=model.device)
        try:
            if clamped:
                assert engine.set_role_budget(
                    batching_engine.RoleBudget.for_role(
                        'decode', slots=2, prefill_chunk=16))
            out[name] = [engine.generate(p, 10) for p in PROMPTS]
            if clamped:
                assert engine.stats()['prefill_chunks'] == sum(
                    len(p) - 1 for p in PROMPTS)
        finally:
            engine.stop()
    assert out['cuda'] == out['cpu'] == out['cpu unclamped']


def test_async_front_serves_the_threaded_fronts_tokens(cuda):
    """One server on the card behind both fronts (no prefix cache, so a
    prompt served twice runs the same path): /generate and
    /generate_stream give the same greedy tokens on either."""
    server = model_server.ModelServer(
        'small', device=cuda, seed=1, continuous_batching=True, max_len=64,
        max_batch=2, prefill_chunk=16, kv_pages=24, page_size=16,
        prefix_caching=False)
    fronts = [async_server.start_background(server),
              model_server.start_background(server)]
    try:
        got = []
        for port, _ in fronts:
            base = f'http://127.0.0.1:{port}'
            tokens = [json.loads(_http(base + http_protocol.GENERATE, body={
                'prompt_ids': [p], 'max_new_tokens': 8})[2])['tokens'][0]
                for p in PROMPTS]
            streams = [[json.loads(line[len(b'data: '):])['token']
                        for line in _http(
                            base + http_protocol.GENERATE_STREAM, body={
                                'prompt_ids': [p],
                                'max_new_tokens': 8})[2].split(b'\n')
                        if line.startswith(b'data: {')]
                       for p in PROMPTS]
            assert streams == tokens
            got.append(tokens)
        assert got[0] == got[1]
    finally:
        for _, stop in fronts:
            stop()
        server.close()


def test_plane_adds_no_device_work(cuda):
    """The sentinel-wrapped step and prefill, between a profiler's
    begin_tick / lap / end_tick, launch the same kernels as the bare
    entries on identical inputs (clones of one cache and state), 8 calls
    each in this thread, and give the same tokens (`plane_check`, the
    check chip_smoke.py runs at llama3-8b)."""
    model = init_params(SMALL.replace(dtype=torch.bfloat16), seed=3,
                        device=cuda)
    engine = batching_engine.ContinuousBatchingEngine(
        model.cfg, model, max_len=64, slots=2, prefill_chunk=16,
        kv_pages=24, page_size=16, device=cuda)
    try:
        for p in PROMPTS:
            engine.generate(p, 10)
        tokens = torch.arange(1, 33, dtype=torch.int32, device=cuda)[None]
        work = plane_check.same_device_work(engine, tokens)
        step, prefill = engine._step, engine._prefill  # pylint: disable=protected-access
    finally:
        engine.stop()
    # One B1 a layer a step, one B3 a layer a prefill, no B2.
    n_layers = model.cfg.n_layers
    assert work['launches'] == (8 * n_layers, 0, 8 * n_layers)
    assert work['kernels_per_call'] > 0
    assert work['ticks'] == plane_check.WARMUP_CALLS + 8
    assert step.__name__ == 'step' and prefill.__name__ == 'prefill'


def _http(url, rid=None, body=None):
    headers = {http_protocol.REQUEST_ID_HEADER: rid} if rid else {}
    data = None
    if body is not None:
        headers['Content-Type'] = 'application/json'
        data = json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers=headers)
    with urllib.request.urlopen(req, timeout=300) as resp:
        return (resp.status, resp.headers.get(
            http_protocol.REQUEST_ID_HEADER), resp.read())


def test_observability_routes_on_the_card(cuda):
    server = model_server.ModelServer(
        'small', device=cuda, seed=1, continuous_batching=True, max_len=64,
        max_batch=2, prefill_chunk=16, kv_pages=24, page_size=16)
    port, stop = model_server.start_background(server)
    base = f'http://127.0.0.1:{port}'
    try:
        code, rid, body = _http(base + http_protocol.GENERATE, 'card-1',
                                {'prompt_ids': [PROMPTS[2]],
                                 'max_new_tokens': 6})
        assert code == 200 and rid == 'card-1'
        tokens = json.loads(body)['tokens'][0]
        plane_check.settle(server.engine)
        parsed = metrics.parse_exposition(
            _http(base + http_protocol.METRICS)[2].decode())
        stats = server.engine.stats()
        assert parsed['skytpu_engine_decode_kernel_pallas'][()] == 1
        assert parsed['skytpu_engine_busy_slots'][()] == 0
        assert stats['ticks'] > 0 and stats['tokens_generated'] == 6
        [seg] = json.loads(_http(
            base + http_protocol.SPANS + '?request_id=card-1')[2])[
                'segments']
        assert seg['status'] == 'ok' and seg['tokens'] == len(tokens)
        assert seg['ttft_ms'] <= seg['duration_ms']
        prof = json.loads(_http(base + http_protocol.PROFILE)[2])['profile']
        assert prof['ring'] and set(prof['phases']) <= set(
            profiling.PHASES)
        peak = torch.cuda.max_memory_allocated(cuda)
        for rec in prof['ring']:
            assert 0 < rec['mem_bytes'] <= peak
            assert sum(d for _, _, d in rec['phases']) <= rec['dur_s'] + 1e-9
        records = json.loads(_http(
            base + http_protocol.LOGS + '?request_id=card-1')[2])['records']
        assert [r['msg'] for r in records] == [
            f'POST {http_protocol.GENERATE} -> 200']
    finally:
        stop()
        server.close()


# ------------------------------------------------------------ tensor ranks

# A llama3-8b tensor rank's heads at tensor 2 and 4.
TENSOR_HEADS = [(16, 4), (8, 2)]


@pytest.mark.parametrize('quantized,s_q', [(False, 1), (True, 5)],
                         ids=['native', 'int8'])
@pytest.mark.parametrize('h_q,h_kv', TENSOR_HEADS, ids=['tp2', 'tp4'])
def test_paged_kernel_at_a_tensor_ranks_heads(cuda, quantized, s_q, h_q,
                                              h_kv):
    """B1 (bf16, S = 1) and B2 (int8, S = 5) at a tensor rank's heads on
    the serving tick's ragged lengths; two launches bit-equal."""
    gen = torch.Generator(device=cuda).manual_seed(h_q)
    lengths, ps, rows, d = [1, 15, 16, 17, 1000], 16, 64, 128
    k, v = _pool(gen, 1 + len(lengths) * rows, h_kv, ps, d, torch.bfloat16,
                 quantized, cuda)
    q = torch.randn((len(lengths), h_q, s_q, d), generator=gen,
                    device=cuda).to(torch.bfloat16)
    tables, lengths = _paged_tables(lengths, s_q, ps, rows, d)
    tables, lengths = tables.to(cuda), lengths.to(cuda)
    out = paged_attention.paged_attention(q, k, v, tables, lengths)
    again = paged_attention.paged_attention(q, k, v, tables, lengths)
    ref = paged_attention._paged_attention_reference(  # pylint: disable=protected-access
        q, k, v, tables, lengths, sm_scale=d ** -0.5)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize('h,h_kv', TENSOR_HEADS, ids=['tp2', 'tp4'])
def test_flash_kernel_at_a_tensor_ranks_heads(cuda, h, h_kv):
    """B3 at a tensor rank's heads: the 512-token prefill chunk."""
    gen = torch.Generator(device=cuda).manual_seed(h)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda).to(
        torch.bfloat16) for shape in ((1, h, 512, 128), (1, h_kv, 512, 128),
                                      (1, h_kv, 512, 128)))
    out = attention.flash_attention(q, k, v)
    ref = attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=True, sm_scale=128 ** -0.5)
    torch.cuda.synchronize()
    torch.testing.assert_close(out.float(), ref.float(), atol=2e-2,
                               rtol=2e-2)


@pytest.mark.parametrize('kv_pages', [24, None], ids=['paged', 'dense'])
def test_tensor_engine_gpu_matches_cpu(cuda, kv_pages):
    """A tensor-2 engine (ranks on the card, the kernels) and the same
    ranks on the CPU (the plain versions) give the same greedy tokens,
    f32."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    gpu_model = init_params(SMALL, seed=2, device=cuda)
    cpu_model = convert.from_jax_params(
        SMALL, convert.to_jax_params(gpu_model), device='cpu')
    out = {}
    for model in (gpu_model, cpu_model):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=2),
                                   [model.device] * 2)
        tp = convert.to_tensor_parallel(SMALL, model, mesh)
        engine = batching_engine.ContinuousBatchingEngine(
            SMALL, tp, max_len=64, slots=2, prefill_chunk=16,
            kv_pages=kv_pages, page_size=16, device=model.device)
        try:
            out[model.device.type] = [engine.generate(p, 10)
                                      for p in PROMPTS]
        finally:
            engine.stop()
    assert out['cuda'] == out['cpu']


@pytest.mark.parametrize('layout', ['tensor 4', 'sequence 2 x tensor 2'])
def test_tensor_ranks_on_four_cards_match_one_card(cuda, layout):
    """Tensor 4 (and a slice of sequence 2 x tensor 2) with one rank on
    each of four cards gives the tokens the same ranks give on one card
    (the kernels and their inputs are the same; the copies between
    cards change no bits), bf16, prompts over the SP threshold."""
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four NVIDIA GPUs')
    from skypilot_tpu_torch.serve import slice_replica
    cfg = SMALL.replace(d_model=512, n_heads=8, n_kv_heads=4,
                        dtype=torch.bfloat16)
    model = init_params(cfg, seed=3, device=cuda)
    prompts = [list(range(1, 40)), [5, 6, 7], list(range(7, 60))]
    out = {}
    for cards in ([cuda] * 4,
                  [torch.device('cuda', i) for i in range(4)]):
        axes = ({'tensor': 4} if layout == 'tensor 4' else
                {'sequence': 2, 'tensor': 2})
        mesh = slice_replica.build_slice_mesh(4, cfg, devices=cards,
                                              **axes)
        engine = slice_replica.SliceReplicaEngine(
            cfg, model, num_hosts=4, mesh=mesh, sp_threshold=32,
            max_len=128, slots=2, prefill_chunk=16, kv_pages=48,
            page_size=16, device=cuda)
        try:
            out[len(set(cards))] = [engine.generate(p, 12) for p in prompts]
        finally:
            engine.stop()
    assert out[4] == out[1]


MOE_SMALL = SMALL.replace(n_experts=4, expert_top_k=2)


@pytest.mark.parametrize('kv_pages', [24, None], ids=['paged', 'dense'])
def test_moe_tensor_engine_gpu_matches_cpu(cuda, kv_pages):
    """An MoE model (head_dim 64: `tiny`'s 16 has no kernel) at tensor
    2: its ranks on the card (the kernels) and the same ranks on the
    CPU (the plain versions) give the same greedy tokens, f32."""
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    gpu_model = init_params(MOE_SMALL, seed=4, device=cuda)
    cpu_model = convert.from_jax_params(
        MOE_SMALL, convert.to_jax_params(gpu_model), device='cpu')
    out = {}
    for model in (gpu_model, cpu_model):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=2),
                                   [model.device] * 2)
        tp = convert.to_tensor_parallel(MOE_SMALL, model, mesh)
        engine = batching_engine.ContinuousBatchingEngine(
            MOE_SMALL, tp, max_len=64, slots=2, prefill_chunk=16,
            kv_pages=kv_pages, page_size=16, device=model.device)
        try:
            out[model.device.type] = [engine.generate(p, 10)
                                      for p in PROMPTS]
        finally:
            engine.stop()
    assert out['cuda'] == out['cpu']


def test_moe_tensor_ranks_on_four_cards_match_one_card(cuda):
    """mixtral-8x7b width at depth 8, tensor 4: one rank on each of four
    cards gives the greedy tokens the same ranks give on one card (the
    kernels, the routing and their inputs are the same; the copies
    between cards change no bits), bf16, paged.  The weights are drawn
    onto the ranks one leaf at a time (`init_tensor_parallel`)."""
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four NVIDIA GPUs')
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = configs.get_config('mixtral-8x7b', n_layers=8)
    prompts = [list(range(1, 40)), [5, 6, 7], list(range(7, 300))]
    out = {}
    for cards in ([cuda] * 4,
                  [torch.device('cuda', i) for i in range(4)]):
        mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(tensor=4), cards)
        tp = convert.init_tensor_parallel(cfg, mesh, seed=5)
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, tp, max_len=512, slots=2, kv_pages=96, page_size=16,
            device=cuda)
        try:
            out[len(set(cards))] = [engine.generate(p, 12) for p in prompts]
        finally:
            engine.stop()
        del tp, engine
        torch.cuda.empty_cache()
    assert out[4] == out[1]


def _narrow_pipeline_cfg(dtype):
    """llama3-8b head shapes cut narrow: d_model 512, 4/2 heads of 128,
    2 layers (one a stage at pipeline 2), d_ff 1024, vocab 1024."""
    return configs.get_config('tiny', d_model=512, n_heads=4, n_kv_heads=2,
                              d_ff=1024, vocab_size=1024, max_seq_len=512,
                              remat=True, dtype=dtype)


@pytest.mark.parametrize('dtype,m', [(torch.bfloat16, 1),
                                     (torch.float32, 2)],
                         ids=['bf16-M1', 'f32-M2'])
def test_pipeline_step_matches_unsharded(cuda, dtype, m):
    """A pipeline-2 step over two entries of cuda:0 at M microbatches
    against the unsharded step from the same seed, batch 4 x 256: the
    loss within rtol 1e-5 and every gradient within 1e-3 of max
    |unsharded| (phase 7e's f32 cut).  bf16 runs at M = 1, where each
    stage's GEMMs take the unsharded step's rows (a microbatch's fewer
    rows may take another cuBLAS tiling, so bf16 at M > 1 is held only
    by phase 7e's 1e-2 on the loss).  B3 launches 2 L M (remat), B4
    and B5 L M."""
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    cfg = _narrow_pipeline_cfg(dtype)
    gen = torch.Generator().manual_seed(3)
    batch = {'tokens': torch.randint(0, 1024, (4, 257), generator=gen
                                     ).to(cuda)}
    plain, _ = train.create_train_state(cfg, device=cuda, seed=2)
    want = train.value_and_grad(plain, batch)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=2),
                               [cuda] * 2)
    piped, placements = train.create_train_state(cfg, mesh=mesh, seed=2)
    assert placements['layers.1.mlp.up_proj.kernel'].at == (('pipeline', 1),)
    before = dict(attention.LAUNCHES)
    got = train.value_and_grad(piped, batch, train.TrainConfig(accum_steps=m))
    torch.cuda.synchronize()
    launched = {k: attention.LAUNCHES[k] - before[k] for k in before}
    assert launched == {'flash_fwd': 2 * 2 * m, 'flash_bwd_dq': 2 * m,
                        'flash_bwd_dkv': 2 * m}
    torch.testing.assert_close(got.to(cuda), want, rtol=1e-5, atol=0)
    for name, p in plain.model.named_parameters():
        full = torch.empty_like(p.grad)
        for t, idx in piped.shards.pieces(name):
            full[idx] = t.grad
        scale = float(p.grad.abs().max())
        assert float((full - p.grad).abs().max()) <= 1e-3 * scale, name


def test_pipeline_on_four_cards_matches_one_card(cuda):
    """pipeline 2 x tensor 2 at M = 2 (f32, the narrow shapes above):
    one mesh position on each of four cards against the same mesh on
    four entries of cuda:0, two steps' losses within rel 1e-6; each
    stage's layer blocks on its stage's cards, the embedding, final
    norm and head on both stages' cards, the copies bit-equal after the
    steps."""
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    from skypilot_tpu_torch.parallel import pipeline
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four NVIDIA GPUs')
    cfg = _narrow_pipeline_cfg(torch.float32)
    gen = torch.Generator().manual_seed(3)
    batch = {'tokens': torch.randint(0, 1024, (4, 257), generator=gen)}
    losses = []
    for devices in ([cuda] * 4, [torch.device('cuda', i) for i in range(4)]):
        mesh = mesh_lib.build_mesh(
            mesh_lib.MeshConfig(data=1, pipeline=2, tensor=2), devices)
        state, placements = pipeline.create_pipeline_train_state(
            cfg, mesh=mesh, batch_size=4, seq_len=256, seed=2)
        _assert_copies_on_their_cards(state, placements, devices)
        step = pipeline.pipeline_train_step(cfg, mesh, 2)
        losses.append([float(step(state, batch)[1]['loss'])
                       for _ in range(2)])
        assert (train.check_copies(state) > 0) == (len(set(devices)) > 1)
        del state
        torch.cuda.empty_cache()
    assert losses[1] == pytest.approx(losses[0], rel=1e-6)


def _two_hosts(host_devices, backend, tmp_path, extra=()):
    """Two `train_llama` hosts of a gang (a free coordinator port) at
    `small`'s width, 2 layers, bf16, remat, batch 2 x 256 a host, 3
    steps, host r over host_devices[r] (`extra` flags); -> each host's
    JSON line."""
    import os
    import socket
    import subprocess
    import sys
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        port = s.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    try:
        for rank, devices in enumerate(host_devices):
            env = {**os.environ, 'PYTHONPATH': repo,
                   'SKYTPU_NUM_HOSTS': str(len(host_devices)),
                   'SKYTPU_HOST_RANK': str(rank),
                   'SKYTPU_COORDINATOR_ADDRESS': f'127.0.0.1:{port}',
                   'SKYTPU_BENCHMARK_LOG_DIR': str(tmp_path / f'bench{rank}')}
            env.pop('SKYTPU_CHECKPOINT_DIR', None)
            with open(tmp_path / f'host{rank}.log', 'w',
                      encoding='utf-8') as out:
                procs.append(subprocess.Popen(
                    [sys.executable, '-m', 'skypilot_tpu_torch.train_llama',
                     '--model', 'small', '--layers', '2', '--batch-size', '2',
                     '--seq-len', '256', '--steps', '3', '--mesh-devices',
                     ','.join(devices), '--dist-backend', backend,
                     *extra],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait(timeout=300)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    out = []
    for rank, proc in enumerate(procs):
        text = (tmp_path / f'host{rank}.log').read_text()
        assert proc.returncode == 0, text[-3000:]
        out.append(json.loads([l for l in text.splitlines()
                               if l.startswith('{"host"')][0]))
    return out


def _one_process(devices, tmp_path, monkeypatch, extra=()):
    """The same run in this process over one mesh of `devices` (data
    len(devices)) with the hosts' global batch of 4; -> (losses,
    launches)."""
    from skypilot_tpu_torch import train_llama
    from skypilot_tpu_torch.callbacks import base as callbacks
    monkeypatch.setenv(callbacks.ENV_LOG_DIR, str(tmp_path / 'bench'))
    monkeypatch.delenv('SKYTPU_CHECKPOINT_DIR', raising=False)
    monkeypatch.setattr(callbacks, '_instance', None)
    before = dict(attention.LAUNCHES)
    history, state = train_llama.run(
        ['--model', 'small', '--layers', '2', '--batch-size', '4',
         '--seq-len', '256', '--steps', '3', '--mesh-devices',
         ','.join(devices), *extra])
    launched = {k: attention.LAUNCHES[k] - before[k] for k in before}
    del state
    torch.cuda.empty_cache()
    return [h['loss'] for h in history], launched


def _hold_hosts(hosts, losses, positions):
    for h in hosts:
        assert h['losses'][0] == pytest.approx(losses[0], rel=1e-5)
        assert h['losses'][1:] == pytest.approx(losses[1:], rel=1e-2)
        assert h['losses'][-1] < h['losses'][0]
        # Remat, no sequence or tensor axis: 2 L / L / L a step and a
        # data position of the host's mesh.
        assert h['launches'] == {'flash_fwd': 12 * positions,
                                 'flash_bwd_dq': 6 * positions,
                                 'flash_bwd_dkv': 6 * positions,
                                 'paged_attention': 0,
                                 'paged_attention_int8': 0}
        assert h['reduce_bytes'] > 0 and len(h['reduce_ms']) == 3
    assert len({h['digest'] for h in hosts}) == 1


@pytest.mark.parametrize('backend', ['gloo-one-card', 'nccl'])
def test_two_hosts_match_one_process(cuda, backend, tmp_path, monkeypatch):
    """Two hosts of one card position each ('gloo-one-card': both on
    cuda:0 over gloo, which stages the gradients through host memory;
    'nccl': cuda:0 and cuda:1, skipped with one card) against one
    process over a data-2 mesh of two entries of cuda:0 with the same
    global batch of 4: step-1 loss within rtol 1e-5 (the same
    parameters, summed in another order), steps 2-3 within 1e-2, equal
    digests, each host's launches its one-position mesh's."""
    del cuda
    if backend == 'nccl' and torch.cuda.device_count() < 2:
        pytest.skip('needs two NVIDIA GPUs: NCCL takes one card a rank')
    host_devices = ([['cuda:0'], ['cuda:0']] if backend == 'gloo-one-card'
                    else [['cuda:0'], ['cuda:1']])
    hosts = _two_hosts(host_devices, backend.split('-')[0], tmp_path)
    assert [h['backend'] for h in hosts] == [backend.split('-')[0]] * 2
    losses, launched = _one_process(['cuda:0', 'cuda:0'], tmp_path,
                                    monkeypatch)
    assert launched['flash_fwd'] == 2 * 12
    _hold_hosts(hosts, losses, positions=1)


def test_two_hosts_on_four_cards_match_one_process(cuda, tmp_path,
                                                   monkeypatch):
    """Two hosts of two cards each over NCCL against one process over
    the four cards, the same holds as above: global data 4 (a host's
    blocks on its first card), then data 2 x fsdp 2 (a host's blocks on
    both its cards: the group stages the second card's buckets through
    the first)."""
    del cuda
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four NVIDIA GPUs')
    for n, extra in enumerate(((), ('--fsdp', '2'))):
        run = tmp_path / str(n)
        run.mkdir()
        hosts = _two_hosts([['cuda:0', 'cuda:1'], ['cuda:2', 'cuda:3']],
                           'nccl', run, extra)
        losses, _ = _one_process([f'cuda:{i}' for i in range(4)], run,
                                 monkeypatch, extra)
        _hold_hosts(hosts, losses, positions=2)


def test_pipeline_hosts_over_nccl_match_one_process(cuda, tmp_path):
    """Pipeline 2 across two hosts over NCCL, a card a host
    (`profile_pipeline` as a gang: each host runs its stage and sends
    the boundary to the other), against one process's pipeline 2 over
    the same two cards on the same global batch and seed: step-1 loss
    within rtol 1e-5, step 2 within 1e-2, equal digests, each host's
    launches its stage's share (2 L_h M / L_h M / L_h M a step)."""
    import os
    import socket
    import subprocess
    import sys
    from skypilot_tpu_torch import profile_pipeline
    from skypilot_tpu_torch.parallel import pipeline
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    del cuda
    if torch.cuda.device_count() < 2:
        pytest.skip('needs two NVIDIA GPUs: NCCL takes one card a rank')
    with socket.socket() as sock:
        sock.bind(('127.0.0.1', 0))
        port = sock.getsockname()[1]
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    try:
        for rank in range(2):
            env = {**os.environ, 'PYTHONPATH': repo,
                   'SKYTPU_NUM_HOSTS': '2', 'SKYTPU_HOST_RANK': str(rank),
                   'SKYTPU_COORDINATOR_ADDRESS': f'127.0.0.1:{port}'}
            with open(tmp_path / f'host{rank}.log', 'w',
                      encoding='utf-8') as out:
                procs.append(subprocess.Popen(
                    [sys.executable, '-m',
                     'skypilot_tpu_torch.profile_pipeline', '--devices',
                     f'cuda:{rank}', '--model', 'small', '--layers', '2',
                     '--batch', '2', '--seq', '256', '--microbatches', '2',
                     '--steps', '1', '--dist-backend', 'nccl'],
                    env=env, stdout=out, stderr=subprocess.STDOUT))
        for proc in procs:
            proc.wait(timeout=300)
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    hosts = []
    for rank, proc in enumerate(procs):
        text = (tmp_path / f'host{rank}.log').read_text()
        assert proc.returncode == 0, text[-3000:]
        hosts.append(json.loads([l for l in text.splitlines()
                                 if l.startswith('{"host"')][0]))
    cfg = configs.get_config('small', n_layers=2, remat=True)
    mesh = mesh_lib.build_mesh(mesh_lib.MeshConfig(data=1, pipeline=2),
                               ['cuda:0', 'cuda:1'])
    state, _ = pipeline.create_pipeline_train_state(
        cfg, mesh=mesh, batch_size=2, seq_len=256, seed=0)
    step = pipeline.pipeline_train_step(cfg, mesh, 2)
    batch = {'tokens': profile_pipeline.batch_tokens(cfg.vocab_size, 2,
                                                     256)}
    losses = []
    for _ in range(2):
        state, m = step(state, batch)
        losses.append(float(m['loss']))
    del state
    torch.cuda.empty_cache()
    for h in hosts:
        run = h['pipeline']['2']
        assert h['backend'] == 'nccl'
        assert run['losses'][0] == pytest.approx(losses[0], rel=1e-5)
        assert run['losses'][1] == pytest.approx(losses[1], rel=1e-2)
        # One layer a stage, M = 2, two steps, remat.
        assert run['launches'] == {'flash_fwd': 8, 'flash_bwd_dq': 4,
                                   'flash_bwd_dkv': 4}
        assert run['boundary_bytes'] > 0 and run['reduce_bytes'] > 0
    assert hosts[0]['digest'] == hosts[1]['digest']


def test_elastic_shrink_expand_on_cards(cuda, tmp_path):
    """An ElasticTrainer with data 2 (fsdp inferred) over cuda:0-3
    (data 2 x fsdp 2) takes steps 0-3 saving every 2, shrinks to
    cuda:0-1 (data 2 x fsdp 1; resumes at step 3) and takes steps 3-4,
    then expands back to the four cards (resumes at step 5) and takes
    step 5; f32 at llama3-8b head shapes cut narrow, batch 4 x 256.
    After each restore every block has a copy on each card that holds
    it (the data ranks' replicas), bit-equal to its owner
    (`train.check_copies`), and each card stores the same bytes; the
    recomputed step 3 within rtol 1e-5 of its first run; the journal
    train_resume -> saves 0, 2 -> gang_resize 4 -> 2 -> train_resume 3
    -> save 4 -> gang_resize 2 -> 4 -> train_resume 5; B3 launched
    2 x (data x fsdp) a step at depth 2."""
    from skypilot_tpu_torch.models import train
    from skypilot_tpu_torch.models.elastic import ElasticTrainer
    from skypilot_tpu_torch.observability import events
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    del cuda
    if torch.cuda.device_count() < 4:
        pytest.skip('needs four NVIDIA GPUs')
    cards = [torch.device('cuda', i) for i in range(4)]
    cfg = configs.get_config('tiny', d_model=512, n_heads=4, n_kv_heads=2,
                             d_ff=1024, vocab_size=1024, max_seq_len=512,
                             remat=True)
    journal = events.EventJournal(str(tmp_path / 'training.jsonl'))
    trainer = ElasticTrainer(cfg, checkpoint_dir=str(tmp_path / 'ckpt'),
                             mesh_config=mesh_lib.MeshConfig(data=2,
                                                             fsdp=-1),
                             batch_size=4, seq_len=256, devices=cards,
                             save_interval_steps=2, journal=journal)
    before = attention.LAUNCHES['flash_fwd']
    try:
        first = dict(trainer.train_steps(4))
        for n, steps, resumed in ((2, 2, 3), (4, 1, 5)):
            trainer.resize(cards[:n])
            assert (trainer.step, trainer.resumed_from_checkpoint) == (
                resumed, True)
            _assert_copies_on_their_cards(trainer.state, trainer.shardings,
                                          cards[:n])
            assert train.check_copies(trainer.state) > 0
            assert len(set(trainer.state.shards.device_bytes())) == 1
            got = dict(trainer.train_steps(steps))
            for step in set(got) & set(first):
                torch.testing.assert_close(got[step], first[step],
                                           rtol=1e-5, atol=0)
            first.update({s: v for s, v in got.items() if s not in first})
    finally:
        trainer.close()
    assert sorted(first) == list(range(6))
    assert (attention.LAUNCHES['flash_fwd'] - before ==
            2 * 2 * (4 * 4 + 2 * 2 + 4 * 1))
    seq = [(e['event'], e.get('step'), e.get('from'), e.get('to'))
           for e in journal.read()]
    saves = lambda s: [('checkpoint_save_start', s, None, None),
                       ('checkpoint_save_end', s, None, None)]
    assert seq == ([('train_resume', 0, None, None)] + saves(0) + saves(2) +
                   [('gang_resize', None, 4, 2), ('train_resume', 3, None,
                                                  None)] + saves(4) +
                   [('gang_resize', None, 2, 4),
                    ('train_resume', 5, None, None)])
