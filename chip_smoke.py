#!/usr/bin/env python3
"""Drive the PyTorch port (skypilot_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases (each one that fails makes the script exit non-zero):

1. The device: CUDA must be present; prints the card's name and power
   limit as `nvidia-smi --query-gpu=name,power.limit` gives them.
2. Builds every CUDA kernel of the port from csrc/ (one nvcc per
   source, in parallel) and prints the build seconds.
3. Kernel parity on the card at the Llama-3-8B shapes (h_q 32, h_kv 8,
   d 128, bf16, page size 16): B1 paged decode and B2 int8 paged decode
   with ragged lengths (1, 15, 16, 17, 1000), S = 1 and S = 5, tables
   that include the null page; B3 flash forward at q_len 1, 100, 512
   and q_len < k_len; one f32 case each.  Each kernel is held against
   its plain PyTorch version on the same inputs: bf16 outputs within
   atol/rtol 2e-2 (compared as f32; both accumulate in f32, in
   different orders), f32 within 1e-4, the LSE within 1e-3.  Times
   come from CUDA events, kernel and plain version alike (20 launches
   after 3 warm-up launches); bounds from this run's bytes and FLOPs
   against 3.35 TB/s and 989 TFLOP/s (H100 SXM data sheet), labelled
   by whichever of the two is larger.
4. The main path: ModelServer('llama3-8b') with seeded random weights
   at full width and depth, paged continuous batching, answering
   concurrent POST /generate requests over HTTP (greedy, one seeded
   sampled request, then prefix-cache hits); then an int8-KV engine
   with speculative decoding (k = 4) on the same weights, whose greedy
   tokens must equal the same int8 engine's with speculation off.
   Launch counts are zeroed just before and read just after: every
   kernel must have run on the main path.
5. A reference check: a depth-2, f32 cut of llama3-8b served on the
   GPU (CUDA kernels) and on the CPU (the plain versions) from the same
   weights must give the same greedy tokens.

The line before the last is the `kernels` JSON; the last line is
{"ok": true, "device": {...}}.
"""
from __future__ import annotations

import json
import subprocess
import sys
import threading
import time
import urllib.request

HBM_BYTES_PER_S = 3.35e12       # H100 SXM, NVIDIA data sheet
BF16_FLOPS = 989e12             # dense tensor cores
F32_FLOPS = 67e12               # outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def check_close(name, out, ref, tol) -> float:
    import torch
    err = max_err(out, ref)
    if not torch.isfinite(out.float()).all():
        raise AssertionError(f'{name}: non-finite output')
    torch.testing.assert_close(out.float(), ref.float(), atol=tol, rtol=tol,
                               msg=lambda m: f'{name}: {m}')
    return err


# ------------------------------------------------------------ phase 3


def paged_case(dev, dtype, quantized, s_q, seed):
    """Pool, q, tables, lengths at the 8B decode shapes."""
    import torch
    from skypilot_tpu_torch.models import decode
    gen = torch.Generator(device=dev).manual_seed(seed)
    b, h_q, h_kv, d, ps, rows = 5, 32, 8, 128, 16, 64
    lengths = [1, 15, 16, 17, 1000]
    n_pages = 1 + b * rows
    kshape = (n_pages, h_kv, ps, d)
    k = torch.randn(kshape, generator=gen, device=dev)
    v = torch.randn(kshape, generator=gen, device=dev)
    if quantized:
        kq, ks = decode._quant_kv(k)  # pylint: disable=protected-access
        vq, vs = decode._quant_kv(v)  # pylint: disable=protected-access
        k_leaf, v_leaf = {'q': kq, 'scale': ks}, {'q': vq, 'scale': vs}
    else:
        k_leaf, v_leaf = k.to(dtype), v.to(dtype)
    tables = torch.zeros((b, rows), dtype=torch.int32)
    perm = torch.randperm(n_pages - 1, generator=torch.Generator()
                          .manual_seed(seed)) + 1
    for i, length in enumerate(lengths):
        need = -(-(length + s_q) // ps)
        tables[i, :need] = perm[i * rows:i * rows + need].to(torch.int32)
    tables[0, 0] = 0                    # a live row on the null page
    q = torch.randn((b, h_q, s_q, d), generator=gen, device=dev).to(dtype)
    return (q, k_leaf, v_leaf, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def bound(n_bytes, flops, peak):
    """(bound_ms, bound_by): the larger of the bytes' time over the
    memory rate and the operations' time over the peak rate."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, flops / peak
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def paged_bound(q, k_leaf, tables, lengths, quantized):
    b, h_q, s_q, d = q.shape
    pool = k_leaf['q'] if quantized else k_leaf
    h_kv, ps = pool.shape[1], pool.shape[2]
    pages = sum(min(tables.shape[1], -(-(int(n) + s_q) // ps))
                for n in lengths.tolist())
    per_token = d * pool.element_size() + (4 if quantized else 0)
    kv_bytes = 2 * pages * h_kv * ps * per_token
    io_bytes = 2 * q.numel() * q.element_size() + tables.numel() * 4 + b * 4
    keys = sum(int(n) + s_q for n in lengths.tolist())
    flops = 4 * h_q * s_q * keys * d
    peak = F32_FLOPS if q.dtype.itemsize == 4 else BF16_FLOPS
    return bound(kv_bytes + io_bytes, flops, peak)


def check_paged(dev, quantized):
    import torch
    from skypilot_tpu_torch.ops import paged_attention as pa
    errs = []
    timed = None
    cases = [(torch.bfloat16, 1), (torch.bfloat16, 5), (torch.float32, 5)]
    for dtype, s_q in cases:
        q, kl, vl, tables, lengths = paged_case(dev, dtype, quantized, s_q,
                                                seed=s_q)
        scale = q.shape[-1] ** -0.5
        out = pa.paged_attention(q, kl, vl, tables, lengths)
        ref = pa._paged_attention_reference(  # pylint: disable=protected-access
            q, kl, vl, tables, lengths, sm_scale=scale)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = f'paged{"_int8" if quantized else ""} {dtype} S={s_q}'
        errs.append(check_close(name, out, ref, tol))
        log(f'  {name}: max_abs_err {errs[-1]:.3g} (tol {tol})')
        # Timed at the main path's tick: S = 1 native, S = 5 (spec) int8.
        if dtype == torch.bfloat16 and s_q == (5 if quantized else 1):
            timed = (q, kl, vl, tables, lengths, scale)
    q, kl, vl, tables, lengths, scale = timed
    ms = time_ms(lambda: pa.paged_attention(q, kl, vl, tables, lengths))
    plain = time_ms(lambda: pa._paged_attention_reference(  # pylint: disable=protected-access
        q, kl, vl, tables, lengths, sm_scale=scale))
    bound_ms, bound_by = paged_bound(q, kl, tables, lengths, quantized)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def check_flash(dev):
    import torch
    import torch.nn.functional as F
    from skypilot_tpu_torch.ops import attention
    errs = []
    h, h_kv, d = 32, 8, 128
    cases = [(torch.bfloat16, 1, 1), (torch.bfloat16, 100, 100),
             (torch.bfloat16, 512, 512), (torch.bfloat16, 100, 612),
             (torch.float32, 100, 100)]
    timed = None
    for dtype, q_len, k_len in cases:
        gen = torch.Generator(device=dev).manual_seed(q_len + k_len)
        q = torch.randn((1, h, q_len, d), generator=gen, device=dev)
        k = torch.randn((1, h_kv, k_len, d), generator=gen, device=dev)
        v = torch.randn((1, h_kv, k_len, d), generator=gen, device=dev)
        q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
        out, lse = attention.flash_attention_with_lse(q, k, v)
        ref, ref_lse = attention._blockwise_attention(  # pylint: disable=protected-access
            q, k, v, causal=True, sm_scale=d ** -0.5, return_lse=True)
        torch.cuda.synchronize()
        tol = 1e-4 if dtype == torch.float32 else 2e-2
        name = f'flash {dtype} q_len={q_len} k_len={k_len}'
        errs.append(check_close(name, out, ref, tol))
        check_close(name + ' lse', lse, ref_lse, 1e-3)
        log(f'  {name}: max_abs_err {errs[-1]:.3g} (tol {tol})')
        if dtype == torch.bfloat16 and q_len == k_len == 512:
            timed = (q, k, v)
    q, k, v = timed
    b, _, n, _ = q.shape
    ms = time_ms(lambda: attention.flash_attention(q, k, v))
    plain = time_ms(lambda: attention._blockwise_attention(  # pylint: disable=protected-access
        q, k, v, causal=True, sm_scale=d ** -0.5))
    library = time_ms(lambda: F.scaled_dot_product_attention(
        q, k, v, is_causal=True, enable_gqa=True))
    flops = 4 * b * h * d * (n * (n + 1) // 2)
    io = (2 * q.numel() + 2 * k.numel()) * q.element_size() + b * h * n * 4
    bound_ms, bound_by = bound(io, flops, BF16_FLOPS)
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=library)


# ------------------------------------------------------------ phase 4


def post(port, body):
    from skypilot_tpu_torch.serve import http_protocol
    req = urllib.request.Request(
        f'http://127.0.0.1:{port}{http_protocol.GENERATE}',
        data=json.dumps(body).encode(),
        method='POST', headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=600) as resp:
        return resp.status, json.loads(resp.read())


def prompt(seed, n, vocab):
    import torch
    gen = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (n,), generator=gen).tolist()


def serve_over_http(server, vocab, new_tokens):
    """Concurrent /generate round, then a prefix-hit round."""
    from skypilot_tpu_torch.serve import http_protocol
    from skypilot_tpu_torch.serve import model_server
    port, stop = model_server.start_background(server)
    try:
        with urllib.request.urlopen(
                f'http://127.0.0.1:{port}{http_protocol.HEALTH}',
                timeout=60) as resp:
            health = json.loads(resp.read())
        if resp.status != 200 or health['status'] != 'ok':
            raise AssertionError(f'/health: {resp.status} {health}')
        lengths = [5, 37, 64, 100, 250, 700]
        bodies = [{'prompt_ids': [prompt(i, n, vocab)],
                   'max_new_tokens': new_tokens} for i, n in
                  enumerate(lengths)]
        bodies[2].update(temperature=0.8, top_k=40, seed=7)
        # Prefix hits: the 100- and 250-token prompts again, new tails.
        hits = [{'prompt_ids': [bodies[i]['prompt_ids'][0][:96] +
                                prompt(50 + i, 9, vocab)],
                 'max_new_tokens': new_tokens} for i in (3, 4)]
        results = [None] * len(bodies)

        def run(i):
            results[i] = post(port, bodies[i])
        t0 = time.perf_counter()
        threads = [threading.Thread(target=run, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        wall = time.perf_counter() - t0
        hit_results = [post(port, body) for body in hits]
    finally:
        stop()
    for (code, out), body in zip(results + hit_results, bodies + hits):
        toks = out['tokens']
        if code != 200 or len(toks) != 1 or len(toks[0]) != new_tokens:
            raise AssertionError(f'/generate {code}: {out}')
        if not all(0 <= t < vocab for t in toks[0]):
            raise AssertionError(f'out-of-vocab tokens: {toks}')
    n_tokens = new_tokens * len(bodies)
    return n_tokens / wall, wall


def int8_spec_parity(cfg, model, dev, new_tokens):
    from skypilot_tpu_torch.serve import batching_engine
    prompts = [prompt(100 + i, n, cfg.vocab_size)
               for i, n in enumerate([12, 60, 130, 333])]
    out = {}
    stats = {}
    for spec in (0, 4):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=1024, slots=8, kv_pages=1024,
            page_size=16, quantize_kv=True, spec_tokens=spec, device=dev)
        try:
            reqs = [engine.submit(p, new_tokens) for p in prompts]
            out[spec] = [r.result(timeout=600) for r in reqs]
            stats[spec] = engine.stats()
        finally:
            engine.stop()
    if out[0] != out[4]:
        raise AssertionError(f'int8 greedy spec-on != spec-off:\n'
                             f'{out[4]}\n{out[0]}')
    return stats[4]


def reference_check(dev):
    """Depth-2 f32 llama3-8b: GPU kernels vs the CPU plain versions."""
    import torch
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models import decode
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    cfg = configs.get_config('llama3-8b', n_layers=2, dtype=torch.float32)
    gpu_model = init_params(cfg, seed=1, device=dev)
    cpu_model = convert.from_jax_params(
        cfg, convert.to_jax_params(gpu_model), device='cpu')
    prompts = [prompt(200, 12, cfg.vocab_size),
               prompt(201, 40, cfg.vocab_size)]
    toks = {}
    for device, model in (('gpu', gpu_model), ('cpu', cpu_model)):
        engine = batching_engine.ContinuousBatchingEngine(
            cfg, model, max_len=128, slots=2, kv_pages=32, page_size=16,
            device=model.device)
        try:
            toks[device] = [engine.generate(p, 12) for p in prompts]
        finally:
            engine.stop()
    if toks['gpu'] != toks['cpu']:
        raise AssertionError(f'GPU vs CPU greedy tokens differ:\n'
                             f'{toks["gpu"]}\n{toks["cpu"]}')
    p = torch.tensor([prompts[1]])
    gl, _ = decode.prefill(cfg, gpu_model, p.to(dev), max_len=64)
    cl, _ = decode.prefill(cfg, cpu_model, p, max_len=64)
    err = max_err(gl.cpu(), cl)
    if err > 1e-3:
        raise AssertionError(f'prefill logits GPU vs CPU: {err}')
    return err


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: no CUDA device', file=sys.stderr)
        return 2
    try:
        from skypilot_tpu_torch.ops import _build
        from skypilot_tpu_torch.ops import attention
        from skypilot_tpu_torch.ops import paged_attention
    except ImportError as e:
        print(f'chip_smoke: the port is not importable: {e}',
              file=sys.stderr)
        return 2
    dev = torch.device('cuda', 0)
    torch.cuda.set_device(dev)
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout.strip()
    log(smi.splitlines()[0])
    log(f'torch {torch.__version__} cuda {torch.version.cuda} '
        f'devices {torch.cuda.device_count()}')

    t0 = time.perf_counter()
    built = _build.build_all()
    log(f'build: {time.perf_counter() - t0:.1f}s '
        f'({", ".join(f"{k} {v:.1f}s" for k, v in built.items())})')

    log('kernel parity (8B shapes):')
    results = {
        'paged_attention': check_paged(dev, quantized=False),
        'paged_attention_int8': check_paged(dev, quantized=True),
        'flash_fwd': check_flash(dev),
    }
    for name, r in results.items():
        log(f'  {name}: {r["ms"]:.4f} ms (plain {r["plain_ms"]:.4f}, '
            f'bound {r["bound_ms"]:.4f} by {r["bound_by"]}, library '
            f'{r["library_ms"]})')
    counters = {'paged_attention': paged_attention.LAUNCHES,
                'paged_attention_int8': paged_attention.LAUNCHES,
                'flash_fwd': attention.LAUNCHES}

    from skypilot_tpu_torch.serve import model_server
    new_tokens = 32
    for table in (paged_attention.LAUNCHES, attention.LAUNCHES):
        for key in table:
            table[key] = 0
    torch.cuda.reset_peak_memory_stats(dev)
    t0 = time.perf_counter()
    server = model_server.ModelServer(
        'llama3-8b', continuous_batching=True, kv_pages=1024,
        page_size=16, max_len=1024, max_batch=8, seed=0, device=dev)
    torch.cuda.synchronize()
    log(f'llama3-8b init: {time.perf_counter() - t0:.1f}s, '
        f'{torch.cuda.memory_allocated(dev) / 2**30:.2f} GiB')
    try:
        tps, wall = serve_over_http(server, server.cfg.vocab_size,
                                    new_tokens)
        req = server.engine.submit(prompt(9, 100, server.cfg.vocab_size),
                                   new_tokens)
        req.result(timeout=600)
        stats = server.engine.stats()
        log(f'http: {tps:.1f} tokens/s over 6 concurrent requests '
            f'({wall:.2f}s); TTFT (100-token prompt, idle engine) '
            f'{req.ttft_s * 1e3:.1f} ms; prefix hits '
            f'{stats["prefix_cache_hits"]} pages; ticks {stats["ticks"]}')
        spec_stats = int8_spec_parity(server.cfg, server.params, dev,
                                      new_tokens)
        log(f'int8 + spec(4): greedy equal to spec-off; accept len '
            f'{spec_stats["spec_accept_len_mean"]}')
    finally:
        server.close()
    launches = {name: table[name] for name, table in counters.items()}
    log(f'peak memory: {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}'
        f' GiB; main-path launches {launches}')
    missing = [name for name, n in launches.items() if n <= 0]
    if missing:
        raise AssertionError(f'kernels not launched on the main path: '
                             f'{missing}')
    del server
    torch.cuda.empty_cache()
    err = reference_check(dev)
    log(f'reference: depth-2 f32 llama3-8b GPU == CPU greedy tokens; '
        f'prefill logits max_abs_err {err:.3g}')

    sources = {'paged_attention': 'skypilot_tpu_torch/csrc/paged_attention.cu',
               'paged_attention_int8':
                   'skypilot_tpu_torch/csrc/paged_attention.cu',
               'flash_fwd': 'skypilot_tpu_torch/csrc/flash_fwd.cu'}
    replaces = {'paged_attention': 'skypilot_tpu/ops/paged_attention.py:104',
                'paged_attention_int8':
                    'skypilot_tpu/ops/paged_attention.py:138',
                'flash_fwd': 'skypilot_tpu/ops/attention.py:138'}
    kernels = [dict(name=name, route='cuda', source=sources[name],
                    replaces=replaces[name], launches=launches[name],
                    **results[name]) for name in results]
    print(json.dumps({'kernels': kernels}), flush=True)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
