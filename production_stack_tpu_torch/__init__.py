"""PyTorch + CUDA port of the serving engine in ``production_stack_tpu``.

The JAX package stays the reference; this package is a second
implementation beside it, written in PyTorch, with every Pallas kernel
on its path rewritten by hand in CUDA C++ for Hopper (``csrc/``). It
imports nothing of JAX and nothing of ``production_stack_tpu``: the
host-side modules it needs (scheduler, block manager, tokenizer,
protocol) are its own copies.

Entry points run on the card (``device="cuda"``) unless the caller asks
for the CPU, where every kernel wrapper takes its plain PyTorch version.
"""
