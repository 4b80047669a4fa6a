"""Grid-sharded runs on a single-process mesh (port of nlsolvers_tpu/parallel).

mesh.py builds the mesh and cuts it along a batch axis, shards.py holds the
sharded state and the collectives, lanczos.py the sharded Lanczos loops
over the shard kernels (one trajectory or a batch of lanes), spatial.py the
sharded operators, the sharded NLSE and real-wave steps and the
grid-sharded trajectory engines that Datagen's shard_grid runs, batch.py
the trajectory-batch helpers (batched_step, shard_batch, batched_evolve),
distributed.py the multi-process runtime (a gloo group for a sweep's host
collectives, the global mesh, each process's block). The modules are
imported by name.
"""
