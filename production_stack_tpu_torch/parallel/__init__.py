"""Parallel serving and training over torch.distributed
(``production_stack_tpu/parallel/``): the meshes and their process
groups (mesh.py), the name-based sharding rules (sharding.py), the
worker ranks of a tensor- or expert-parallel engine (workers.py), and
the training path: the step and AdamW (train.py), ring attention
(ring_attention.py), GPipe (pipeline.py) and the multichip dry run
(dryrun.py)."""
