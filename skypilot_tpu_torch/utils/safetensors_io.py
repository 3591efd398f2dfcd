"""The safetensors file format, read and written with numpy and torch.

A file is an 8-byte little-endian header length, a JSON header
{name: {'dtype', 'shape', 'data_offsets': [begin, end]}, '__metadata__':
{str: str}} padded with spaces to a multiple of 8 bytes, then the
tensors' raw little-endian bytes.  The port reads HF checkpoints and
writes its own checkpoints (data/checkpoints.py) in this format with
this module alone: no `safetensors` package, and no `ml_dtypes`, since
BF16 is read as raw uint16 bits and viewed as torch.bfloat16.
"""
from __future__ import annotations

import json
import mmap
from typing import (Any, Dict, Iterable, Iterator, List, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

# safetensors dtype name -> (numpy dtype of the raw bytes, torch dtype).
# BF16's raw bytes are uint16 bits: numpy has no bfloat16.
_DTYPES: Dict[str, Tuple[Any, torch.dtype]] = {
    'F64': (np.float64, torch.float64),
    'F32': (np.float32, torch.float32),
    'F16': (np.float16, torch.float16),
    'BF16': (np.uint16, torch.bfloat16),
    'I64': (np.int64, torch.int64),
    'I32': (np.int32, torch.int32),
    'I16': (np.int16, torch.int16),
    'I8': (np.int8, torch.int8),
    'U8': (np.uint8, torch.uint8),
    'BOOL': (np.bool_, torch.bool),
}
_NAMES = {tdt: name for name, (_, tdt) in _DTYPES.items()}


def _np_dtype(name: str):
    try:
        return _DTYPES[name][0]
    except KeyError:
        raise ValueError(f'Unsupported safetensors dtype {name!r}') from None


def dtype_name(dtype: torch.dtype) -> str:
    try:
        return _NAMES[dtype]
    except KeyError:
        raise ValueError(f'No safetensors dtype for {dtype}') from None


def to_torch(arr: np.ndarray, dtype_str: str) -> torch.Tensor:
    """A numpy array of a tensor's raw values (as `get` returns them) as
    a torch tensor of its safetensors dtype, in memory of its own."""
    own = np.array(arr)                       # off the mmap, writable
    if dtype_str == 'BF16':
        return torch.from_numpy(own.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(own)


class SafetensorsFile:
    """One .safetensors file over an mmap.  `get` returns a zero-copy
    numpy view of a tensor's raw values (BF16 as uint16 bits);
    `get_tensor` a torch tensor of the stored dtype, copied."""

    def __init__(self, path: str) -> None:
        self.path = path
        self._f = open(path, 'rb')  # pylint: disable=consider-using-with
        header_len = int.from_bytes(self._f.read(8), 'little')
        if header_len > 100 * 1024 * 1024:
            raise ValueError(f'{path}: implausible header ({header_len}B)')
        header = json.loads(self._f.read(header_len))
        self.metadata: Dict[str, str] = header.pop('__metadata__', None) or {}
        self._entries: Dict[str, Tuple[str, Tuple[int, ...], int, int]] = {}
        data_start = 8 + header_len
        for name, meta in header.items():
            begin, end = meta['data_offsets']
            _np_dtype(meta['dtype'])
            self._entries[name] = (meta['dtype'], tuple(meta['shape']),
                                   data_start + begin, data_start + end)
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)

    def keys(self) -> List[str]:
        """Tensor names in the order their bytes lie in the file."""
        return sorted(self._entries, key=lambda n: self._entries[n][2])

    def dtype(self, name: str) -> str:
        return self._entries[name][0]

    def get(self, name: str) -> np.ndarray:
        dtype_str, shape, begin, end = self._entries[name]
        np_dtype = _np_dtype(dtype_str)
        count = (end - begin) // np.dtype(np_dtype).itemsize
        # frombuffer with an offset is a zero-copy view of the map.
        return np.frombuffer(self._mm, dtype=np_dtype, count=count,
                             offset=begin).reshape(shape)

    def get_tensor(self, name: str) -> torch.Tensor:
        return to_torch(self.get(name), self.dtype(name))

    def close(self) -> None:
        try:
            self._mm.close()
        except BufferError:
            # A view escaped: leave the map to the GC.
            pass
        self._f.close()


Spec = Tuple[str, torch.dtype, Sequence[int]]


def write_file(path: str, specs: Sequence[Spec],
               leaves: Iterable[Tuple[str, Any]],
               metadata: Optional[Dict[str, str]] = None) -> None:
    """Write tensors named and shaped by `specs` (name, dtype, shape),
    whose values `leaves` yields in the same order as (name, value):
    value is a tensor, or an iterable of tensors that are the leaf's
    consecutive slabs along axis 0 (a stacked leaf written layer by
    layer).  Each value is cast to its spec's dtype on the way; only
    one value is in host memory at a time."""
    header: Dict[str, Any] = {}
    offset = 0
    sizes = []
    for name, dtype, shape in specs:
        n = int(np.prod(shape, dtype=np.int64)) * torch.empty(
            (), dtype=dtype).element_size()
        header[name] = {'dtype': dtype_name(dtype),
                        'shape': [int(x) for x in shape],
                        'data_offsets': [offset, offset + n]}
        sizes.append(n)
        offset += n
    if metadata:
        header['__metadata__'] = {str(k): str(v)
                                  for k, v in metadata.items()}
    blob = json.dumps(header, separators=(',', ':')).encode('utf-8')
    blob += b' ' * (-len(blob) % 8)
    with open(path, 'wb') as f:
        f.write(len(blob).to_bytes(8, 'little'))
        f.write(blob)
        it: Iterator[Tuple[str, Any]] = iter(leaves)
        for (name, dtype, shape), size in zip(specs, sizes):
            got, value = next(it)
            if got != name:
                raise ValueError(f'{path}: leaf {got!r} where the header '
                                 f'has {name!r}')
            slabs = [value] if torch.is_tensor(value) else value
            written = 0
            for slab in slabs:
                written += _write_tensor(f, slab, dtype)
            if written != size:
                raise ValueError(f'{path}: {name} has {written} bytes, '
                                 f'its shape {tuple(shape)} {size}')
        f.flush()


def _write_tensor(f, t: torch.Tensor, dtype: torch.dtype) -> int:
    t = t.detach().to('cpu', dtype).contiguous()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    arr = t.numpy()
    f.write(memoryview(arr.reshape(-1)).cast('B'))
    return arr.nbytes
