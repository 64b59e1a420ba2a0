"""Tensor- and expert-parallel serving over torch.distributed
(``production_stack_tpu/parallel/``, its serving half): the mesh and
its process groups (mesh.py), the name-based sharding rules
(sharding.py) and the worker ranks that hold the other shards
(workers.py)."""
