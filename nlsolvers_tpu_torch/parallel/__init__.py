"""Grid-sharded runs on a single-process mesh (port of nlsolvers_tpu/parallel).

mesh.py builds the mesh, shards.py holds the sharded state and the
collectives, lanczos.py the sharded Lanczos loops over the shard kernels,
spatial.py the sharded operators and the sharded SS2 step. The modules are
imported by name.
"""
