"""Device layouts of the port.  Only the slice mesh of a serving
replica (`mesh.py`) is here; meshes for training are a later slice."""
from skypilot_tpu_torch.parallel.mesh import Mesh
from skypilot_tpu_torch.parallel.mesh import MeshConfig
from skypilot_tpu_torch.parallel.mesh import build_mesh

__all__ = ['Mesh', 'MeshConfig', 'build_mesh']
