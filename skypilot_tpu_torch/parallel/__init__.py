"""Device layouts of the port: meshes over device lists (`mesh.py`),
the logical-axis placement rules (`sharding.py`), the gang environment
(`distributed.py`), the collective preflight (`preflight.py`) and the
GPipe schedule over the 'pipeline' axis (`pipeline.py`, imported from
its module as in the reference)."""
from skypilot_tpu_torch.parallel import distributed
from skypilot_tpu_torch.parallel.distributed import initialize_from_env
from skypilot_tpu_torch.parallel.mesh import Mesh
from skypilot_tpu_torch.parallel.mesh import MeshConfig
from skypilot_tpu_torch.parallel.mesh import SliceTopology
from skypilot_tpu_torch.parallel.mesh import build_mesh
from skypilot_tpu_torch.parallel.mesh import elastic_mesh_config
from skypilot_tpu_torch.parallel.mesh import slice_topology
from skypilot_tpu_torch.parallel.sharding import LOGICAL_AXIS_RULES
from skypilot_tpu_torch.parallel.sharding import logical_sharding

__all__ = ['LOGICAL_AXIS_RULES', 'Mesh', 'MeshConfig', 'SliceTopology',
           'build_mesh', 'distributed', 'elastic_mesh_config',
           'initialize_from_env', 'logical_sharding', 'slice_topology']
