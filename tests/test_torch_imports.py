"""Package rules of the PyTorch port (skypilot_tpu_torch/).

- An AST walk: neither the port nor chip_smoke.py imports jax, flax,
  optax, orbax, ml_dtypes, safetensors, or the JAX package
  `skypilot_tpu` (exact-prefix rule, so the port's own name does not
  match); `tokenizers` is imported only inside HFTokenizer.__init__
  (the card has none of these packages).
- Every entry point defaults to CUDA and raises without it unless the
  caller passes device='cpu'.
- Kernels are built at first launch, never at import.
"""
from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / 'skypilot_tpu_torch'
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'optax', 'orbax', 'ml_dtypes',
             'safetensors', 'skypilot_tpu')


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + '.') for f in FORBIDDEN)


def _imports(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.lineno, node.module
        elif (isinstance(node, ast.Call) and
              getattr(node.func, 'id', getattr(node.func, 'attr', None))
              in ('__import__', 'import_module') and node.args and
              isinstance(node.args[0], ast.Constant)):
            yield node.lineno, str(node.args[0].value)


def _port_files():
    files = sorted(PORT.rglob('*.py'))
    assert files, 'port package not found'
    return files + [REPO / 'chip_smoke.py']


def test_exact_prefix_rule():
    assert _forbidden('skypilot_tpu')
    assert _forbidden('skypilot_tpu.models.decode')
    assert _forbidden('jax.numpy')
    assert not _forbidden('skypilot_tpu_torch')
    assert not _forbidden('skypilot_tpu_torch.models')
    assert not _forbidden('jaxtyping')


@pytest.mark.parametrize('path', _port_files(),
                         ids=lambda p: str(p.relative_to(REPO)))
def test_no_jax_or_reference_imports(path):
    bad = [(line, name) for line, name in _imports(path)
           if _forbidden(name)]
    assert not bad, f'{path.relative_to(REPO)} imports {bad}'


def _tokenizers_imports():
    """(file, enclosing class.function) of every import of `tokenizers`
    in the port and chip_smoke.py."""
    found = []
    for path in _port_files():
        tree = ast.parse(path.read_text(), filename=str(path))

        def visit(node, scope):
            for child in ast.iter_child_nodes(node):
                inner = scope
                if isinstance(child, (ast.ClassDef, ast.FunctionDef,
                                      ast.AsyncFunctionDef)):
                    inner = scope + (child.name,)
                names = []
                if isinstance(child, ast.Import):
                    names = [a.name for a in child.names]
                elif isinstance(child, ast.ImportFrom) and child.module:
                    names = [child.module]
                if any(n == 'tokenizers' or n.startswith('tokenizers.')
                       for n in names):
                    found.append((path.relative_to(REPO).as_posix(),
                                  '.'.join(inner)))
                visit(child, inner)
        visit(tree, ())
    return found


def test_tokenizers_only_inside_hf_tokenizer():
    assert _tokenizers_imports() == [
        ('skypilot_tpu_torch/models/tokenizer.py', 'HFTokenizer.__init__')]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)


def test_resolve_device_raises_without_cuda(no_cuda):
    from skypilot_tpu_torch.device import resolve_device
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device()
    with pytest.raises(RuntimeError, match='no CUDA device'):
        resolve_device('cuda')
    assert resolve_device('cpu') == torch.device('cpu')
    with pytest.raises(ValueError):
        resolve_device('meta')


def test_entry_points_default_to_cuda(no_cuda, tmp_path):
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models import convert
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('tiny')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError, match='no CUDA device'):
        convert.from_jax_params(cfg, {})
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model_server.ModelServer('tiny')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        init_params(cfg, seed=0, quantize='int8')
    model = init_params(cfg, seed=0, device='cpu')
    with pytest.raises(RuntimeError, match='no CUDA device'):
        batching_engine.ContinuousBatchingEngine(cfg, model, kv_pages=8,
                                                 max_len=32, page_size=8)
    from skypilot_tpu_torch.data import checkpoints
    checkpoints.save_params(str(tmp_path), 0, convert.param_tree(model))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        checkpoints.restore_params(str(tmp_path))
    with pytest.raises(RuntimeError, match='no CUDA device'):
        model_server.ModelServer('tiny', checkpoint_dir=str(tmp_path))
    assert checkpoints.restore_params(str(tmp_path), device='cpu')
    from skypilot_tpu_torch.parallel import mesh as mesh_lib
    with pytest.raises(RuntimeError, match='no CUDA device'):
        mesh_lib.build_mesh(mesh_lib.MeshConfig(fsdp=2))


def test_engine_dense_mode_names_later_slice():
    """The dense mode serves (tests/test_torch_engine_dense.py), MoE
    models in it too (tests/test_torch_moe.py).  /weights_swap restores
    (the reference's messages: tests/test_torch_real_weights.py)."""
    from skypilot_tpu_torch.models import configs
    from skypilot_tpu_torch.models.transformer import init_params
    from skypilot_tpu_torch.serve import batching_engine
    from skypilot_tpu_torch.serve import model_server
    cfg = configs.get_config('tiny')
    model = init_params(cfg, seed=0, device='cpu')
    engine = batching_engine.ContinuousBatchingEngine(cfg, model,
                                                      device='cpu')
    try:
        assert engine.stats()['decode_kernel'] == 'dense'
    finally:
        engine.stop()
    moe = configs.get_config('tiny-moe')
    moe_model = init_params(moe, seed=0, device='cpu')
    engine = batching_engine.ContinuousBatchingEngine(moe, moe_model,
                                                      device='cpu')
    try:
        assert len(engine.generate([1, 2, 3], 3)) == 3
    finally:
        engine.stop()
    server = model_server.ModelServer('tiny', continuous_batching=True,
                                      device='cpu', params=model)
    try:
        with pytest.raises(ValueError,
                           match='^no checkpoint under /nonexistent$'):
            server.weights_swap({'checkpoint_dir': '/nonexistent'})
    finally:
        server.close()


def test_ops_refuse_other_devices():
    from skypilot_tpu_torch.ops import attention
    from skypilot_tpu_torch.ops import paged_attention
    q = torch.zeros((1, 2, 1, 64), device='meta')
    with pytest.raises(ValueError, match='unsupported device'):
        attention.flash_attention(q, q, q)
    with pytest.raises(ValueError, match='unsupported device'):
        paged_attention.paged_attention(
            q, q, q, torch.zeros((1, 1), dtype=torch.int32, device='meta'),
            torch.zeros((1,), dtype=torch.int32, device='meta'))


def test_kernels_not_built_at_import(monkeypatch, tmp_path):
    code = ('import skypilot_tpu_torch.serve.model_server\n'
            'from skypilot_tpu_torch.ops import _build\n'
            'assert _build._libs == {}, _build._libs\n')
    subprocess.run([sys.executable, '-c', code], check=True, cwd=REPO)
    from skypilot_tpu_torch.ops import _build
    monkeypatch.setenv('SKYTPU_TORCH_BUILD_DIR', str(tmp_path))
    assert _build.build_dir() == str(tmp_path)
    # The source list names every kernel file shipped in csrc/.
    shipped = sorted(p.stem for p in (PORT / 'csrc').glob('*.cu'))
    assert shipped == sorted(_build.SOURCES)


def test_build_dir_is_gitignored():
    from skypilot_tpu_torch.ops import _build
    rel = os.path.relpath(_build.build_dir(), REPO)
    ignored = (REPO / '.gitignore').read_text().split()
    top = rel.split(os.sep)[0]
    assert f'/{top}/' in ignored or f'{top}/' in ignored
