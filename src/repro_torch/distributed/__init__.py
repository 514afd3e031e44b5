"""The multi-device layer of the port (counterpart of ``repro.distributed``
and the mesh shims of ``repro.jax_compat``): the ambient ``DeviceMesh``
and the collectives the model and the train step run on it, data parallel
and tensor parallel over ``model`` (:mod:`.context`), and the sharding
rules with their ``DTensor`` placements and each block's compute view of
its stored shards (:mod:`.sharding`)."""
from .context import get_mesh, mesh_axis_names, set_mesh

__all__ = ["get_mesh", "mesh_axis_names", "set_mesh"]
