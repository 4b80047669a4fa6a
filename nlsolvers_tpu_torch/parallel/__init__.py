"""Grid-sharded runs on a single-process mesh (port of nlsolvers_tpu/parallel).

mesh.py builds the mesh, shards.py holds the sharded state and the
collectives, lanczos.py the sharded Lanczos loops over the shard kernels
(one trajectory or a batch of lanes), spatial.py the sharded operators, the
sharded NLSE and real-wave steps and the grid-sharded trajectory engines
that Datagen's shard_grid runs. The modules are imported by name.
"""
