"""Where the paged decode kernels' (B1, B2) time goes, phase by phase.

    python -m skypilot_tpu_torch.profile_paged [--split-pages 2,4,8]
        [--out PATH]

B1 (native pools) and B2 (int8 pools) are one templated split kernel.
This builds copies of csrc/paged_attention.cu in which that kernel
returns after a phase - entry (the early exit of splits past a slot's
pages), load (q, K and V in shared memory, B2's V dequantized; a cut
waits for every copy in flight, so B1's V, which the full kernel waits
for only before P·V, counts here), scores, softmax, P·V (partials
written) - next to the unchanged source (full: with the merge), each
into its own library under the build directory.  Each
runs through the real wrapper (`ops.paged_attention`) at Llama-3-8B's
decode shapes (32/8 heads, d 128, pages of 16 tokens): B1 with a bf16
pool and q at S = 1 (the serving tick), B2 with an int8 pool and bf16 q
at S = 5 (the speculative tick); 5 slots at ragged lengths (1, 15, 16,
17, 1000) and 8 slots at 1000.  Device time per call from
torch.profiler (summed kernel durations over 50 calls after 5
warm-ups, over 50); a phase's own time is the difference to the one
before.  The full variant's output must equal the shipped library's.

--split-pages also builds the full source with the split span
(kSplitPages) set to each C given, and times B1 at each on both shapes;
each output must agree with the plain version within 2e-2.

Needs a CUDA device and nvcc; prints the JSON (and writes it to --out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess

import torch

from skypilot_tpu_torch.device import resolve_device
from skypilot_tpu_torch.models import decode
from skypilot_tpu_torch.ops import _build
from skypilot_tpu_torch.ops import paged_attention

# (phase, anchor in the split kernel, insert the return before (True) or
# after (False) the anchor); each anchor occurs once in the source.
PHASES = (
    ('entry', '  if (split >= nsplit) return;\n', False),
    ('load', '  // Scores: group grp takes', True),
    ('scores', "  // The split's softmax, one warp a row", True),
    ('softmax', "  // P·V: this thread's column quad cq", True),
    ('pv', "  // The last of the slot's splits to finish merges them all.",
     True),
)
# Returns always (nsplit >= 1) without letting the compiler drop the
# phases before it; copies still in flight land first.
_EXIT = '  if (nsplit > -1) {\n    cp_async_wait_all();\n    return;\n  }\n'
_SPLIT = re.compile(r'constexpr int kSplitPages = \d+;')
SHAPES = {'ragged': [1, 15, 16, 17, 1000], 'full_batch': [1000] * 8}
# The kernel each timed: {name: (int8 pool, S)}.
KERNELS = {'paged_attention': (False, 1), 'paged_attention_int8': (True, 5)}


def variant_sources(source: str) -> dict:
    """{phase: source that returns after it}, plus 'full' = source."""
    out = {}
    for name, anchor, before in PHASES:
        if source.count(anchor) != 1:
            raise ValueError(f'profile_paged: anchor of {name!r} found '
                             f'{source.count(anchor)} times')
        out[name] = source.replace(
            anchor, _EXIT + anchor if before else anchor + _EXIT)
    out['full'] = source
    return out


def split_source(source: str, pages: int) -> str:
    """The source with the split span set to `pages`."""
    if len(_SPLIT.findall(source)) != 1:
        raise ValueError('profile_paged: kSplitPages not found once')
    return _SPLIT.sub(f'constexpr int kSplitPages = {pages};', source)


def _build_variants(dev_dir: str, sources: dict) -> dict:
    os.makedirs(dev_dir, exist_ok=True)
    procs = {}
    for name, text in sources.items():
        src = os.path.join(dev_dir, f'paged_{name}.cu')
        with open(src, 'w', encoding='utf-8') as f:
            f.write(text)
        lib = os.path.join(dev_dir, f'paged_{name}.so')
        cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, '-I', _build.CSRC_DIR,
               '-o', lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        text, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc failed for the {name} variant:\n'
                               f'{text.decode(errors="replace")}')
        libs[name] = ctypes.CDLL(lib)
    return libs


def _case(dev, lengths, seed: int, quantized: bool, s_q: int):
    b, h_q, h_kv, d, ps = len(lengths), 32, 8, 128, 16
    rows = 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (1 + b * rows, h_kv, ps, d)
    leaves = []
    for _ in range(2):
        x = torch.randn(shape, generator=gen, device=dev)
        if quantized:
            vals, scale = decode._quant_kv(x)  # pylint: disable=protected-access
            leaves.append({'q': vals, 'scale': scale})
        else:
            leaves.append(x.to(torch.bfloat16))
    tables = torch.zeros((b, rows), dtype=torch.int32)
    for i, n in enumerate(lengths):
        need = -(-(n + s_q) // ps)
        tables[i, :need] = torch.arange(1 + i * rows, 1 + i * rows + need)
    q = torch.randn((b, h_q, s_q, d), generator=gen,
                    device=dev).to(torch.bfloat16)
    return (q, *leaves, tables.to(dev),
            torch.tensor(lengths, dtype=torch.int32, device=dev))


def _device_ms(fn, iters: int = 50, warmup: int = 5) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    events = prof.events()
    us = sum(e.time_range.end - e.time_range.start for e in events
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError(f'profile_paged: the profiler saw no device time '
                           f'in {len(events)} events')
    return us / 1e3 / iters


def _use(lib) -> None:
    # The wrapper binds whatever library _build holds.
    _build._libs['paged_attention'] = lib  # pylint: disable=protected-access


def _phases(libs: dict, case) -> dict:
    """Cumulative and per-phase device us of the phase variants on one
    case; the full variant must give the shipped library's bits."""
    shipped = _build.library('paged_attention')
    want = paged_attention.paged_attention(*case)
    cumulative = {}
    for name, lib in libs.items():
        _use(lib)
        cumulative[name] = _device_ms(
            lambda: paged_attention.paged_attention(*case)) * 1e3
    _use(libs['full'])
    got = paged_attention.paged_attention(*case)
    _use(shipped)
    if not torch.equal(got, want):
        raise AssertionError('profile_paged: the full variant differs from '
                             'the shipped library')
    names = list(cumulative)
    return {'cumulative_us': cumulative,
            'phase_us': {n: cumulative[n] - (cumulative[names[i - 1]]
                                             if i else 0.0)
                         for i, n in enumerate(names)}}


def _split_sweep(libs: dict, dev) -> dict:
    """{C: {shape: B1's device us}} with the split span set to C."""
    out = {}
    default = paged_attention.SPLIT_PAGES
    try:
        for pages, lib in libs.items():
            paged_attention.SPLIT_PAGES = pages
            _use(lib)
            out[pages] = {}
            for shape, lengths in SHAPES.items():
                case = _case(dev, lengths, len(lengths), False, 1)
                got = paged_attention.paged_attention(*case)
                ref = paged_attention._paged_attention_reference(  # pylint: disable=protected-access
                    *case, sm_scale=case[0].shape[-1] ** -0.5)
                torch.testing.assert_close(got.float(), ref.float(),
                                           atol=2e-2, rtol=2e-2)
                out[pages][shape] = _device_ms(
                    lambda: paged_attention.paged_attention(*case)) * 1e3
    finally:
        paged_attention.SPLIT_PAGES = default
    return out


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--split-pages', default='',
                        help='Comma-separated split spans (pages) at which '
                        'to time B1 as well, e.g. 2,4,8.')
    parser.add_argument('--out', default=None,
                        help='Also write the JSON to this file.')
    args = parser.parse_args(argv)
    dev = resolve_device('cuda')
    with open(os.path.join(_build.CSRC_DIR, 'paged_attention.cu'),
              encoding='utf-8') as f:
        source = f.read()
    sources = variant_sources(source)
    sweep = [int(x) for x in args.split_pages.split(',') if x]
    for pages in sweep:
        sources[f'split_{pages}'] = split_source(source, pages)
    built = _build_variants(
        os.path.join(_build.build_dir(), 'profile_paged'), sources)
    libs = {name: built[name] for name in variant_sources(source)}
    shipped = _build.library('paged_attention')
    smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], check=True,
                         capture_output=True, text=True).stdout
    # The process's first profiler session can miss the device's
    # activity; one on the shipped kernel goes first and is discarded.
    case = _case(dev, SHAPES['ragged'], 0, False, 1)
    try:
        _device_ms(lambda: paged_attention.paged_attention(*case))
    except RuntimeError as e:
        print(f'profile_paged: warm-up session: {e}', flush=True)
    result = {'device': smi.splitlines()[0].strip(),
              'split_pages': paged_attention.SPLIT_PAGES,
              'kernels': {}}
    try:
        for kernel, (quantized, s_q) in KERNELS.items():
            shapes = {}
            for shape, lengths in SHAPES.items():
                case = _case(dev, lengths, len(lengths), quantized, s_q)
                shapes[shape] = dict(lengths=lengths,
                                     **_phases(libs, case))
            result['kernels'][kernel] = {
                's_q': s_q, 'pool': 'int8' if quantized else 'bf16',
                'shapes': shapes}
        if sweep:
            result['split_sweep_us'] = _split_sweep(
                {pages: built[f'split_{pages}'] for pages in sweep}, dev)
    finally:
        _use(shipped)
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w', encoding='utf-8') as f:
            f.write(text)
    return result


if __name__ == '__main__':
    main()
