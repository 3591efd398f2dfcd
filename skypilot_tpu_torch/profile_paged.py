"""Where the int8 paged decode kernel's (B2) time goes, phase by phase.

    python -m skypilot_tpu_torch.profile_paged [--out PATH]

Builds copies of csrc/paged_attention.cu in which the split kernel
returns after a phase - entry (the early exit of splits past a slot's
pages), load (K/V pages, scales and q in shared memory), scores,
softmax, P·V (partials written) - next to the unchanged source (full:
with the merge), each into its own library under the build directory.
Each runs through the real wrapper (`ops.paged_attention`) at
Llama-3-8B's decode shapes (32/8 heads, d 128, int8 pool of 16-token
pages, bf16 q, S = 5 as in the speculative tick): 5 slots at ragged
lengths (1, 15, 16, 17, 1000) and 8 slots at 1000.  Device time per
call from torch.profiler (summed kernel durations over 50 calls after 5
warm-ups, over 50); a phase's own time is the difference to the one
before.  The full variant's output must equal the shipped library's.

Needs a CUDA device and nvcc; prints the JSON (and writes it to --out).
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
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
    ('load', '  cp_async_wait_all();\n  __syncthreads();\n', False),
    ('scores', "  // The split's softmax, one warp a row", True),
    ('softmax', "  // P·V: this thread's column quad cq", True),
    ('pv', "  // The last of the slot's splits to finish merges them all.",
     True),
)
# Returns always (nsplit >= 1) without letting the compiler drop the
# phases before it.
_EXIT = '  if (nsplit > -1) return;\n'
SHAPES = {'ragged': [1, 15, 16, 17, 1000], 'full_batch': [1000] * 8}


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


def _build_variants(dev_dir: str) -> dict:
    with open(os.path.join(_build.CSRC_DIR, 'paged_attention.cu'),
              encoding='utf-8') as f:
        sources = variant_sources(f.read())
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


def _case(dev, lengths, seed: int):
    b, h_q, h_kv, d, ps, s_q = len(lengths), 32, 8, 128, 16, 5
    rows = 64
    gen = torch.Generator(device=dev).manual_seed(seed)
    shape = (1 + b * rows, h_kv, ps, d)
    leaves = []
    for _ in range(2):
        vals, scale = decode._quant_kv(  # pylint: disable=protected-access
            torch.randn(shape, generator=gen, device=dev))
        leaves.append({'q': vals, 'scale': scale})
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
    us = sum(e.time_range.end - e.time_range.start for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA)
    if us <= 0:
        raise RuntimeError('profile_paged: the profiler saw no device time')
    return us / 1e3 / iters


def main(argv=None) -> dict:
    parser = argparse.ArgumentParser()
    parser.add_argument('--out', default=None,
                        help='Also write the JSON to this file.')
    args = parser.parse_args(argv)
    dev = resolve_device('cuda')
    libs = _build_variants(os.path.join(_build.build_dir(), 'profile_paged'))
    shipped = _build.library('paged_attention')
    result = {'device': torch.cuda.get_device_name(0),
              'split_pages': paged_attention.SPLIT_PAGES, 'shapes': {}}
    try:
        for shape, lengths in SHAPES.items():
            case = _case(dev, lengths, seed=len(lengths))
            want = paged_attention.paged_attention(*case)
            cumulative = {}
            for name, lib in libs.items():
                # The wrapper binds whatever library _build holds.
                _build._libs['paged_attention'] = lib  # pylint: disable=protected-access
                cumulative[name] = _device_ms(
                    lambda: paged_attention.paged_attention(*case)) * 1e3
            _build._libs['paged_attention'] = libs['full']  # pylint: disable=protected-access
            got = paged_attention.paged_attention(*case)
            if not torch.equal(got, want):
                raise AssertionError('profile_paged: the full variant '
                                     'differs from the shipped library')
            _build._libs['paged_attention'] = shipped  # pylint: disable=protected-access
            names = list(cumulative)
            result['shapes'][shape] = {
                'lengths': lengths, 'cumulative_us': cumulative,
                'phase_us': {n: cumulative[n] - (cumulative[names[i - 1]]
                                                 if i else 0.0)
                             for i, n in enumerate(names)}}
    finally:
        _build._libs['paged_attention'] = shipped  # pylint: disable=protected-access
    text = json.dumps(result, indent=1)
    print(text, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or '.', exist_ok=True)
        with open(args.out, 'w', encoding='utf-8') as f:
            f.write(text)
    return result


if __name__ == '__main__':
    main()
