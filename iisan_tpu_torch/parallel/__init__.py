"""Meshes of ranks over ``torch.distributed`` (port of
``iisan_tpu/parallel``): ``mesh.make_mesh`` lays the world's ranks on named
axes, ``distributed`` starts the process group and moves rows between
ranks."""
