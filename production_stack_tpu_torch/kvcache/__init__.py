"""KV tiering: device pool -> host DRAM -> local disk -> remote shared
store (``production_stack_tpu/kvcache``).

Token-chunk hashing (chunks.py), tiered byte stores backed by the native
C++ LRU of ``native/pskv.cpp`` (store.py, _native.py), per-tier codecs
(codec.py), the pipelined prefetch walk (pipeline.py), the TPKV wire
protocol and the standalone cache server (protocol.py, server.py), and
the engine-side connector that moves chunks between the device pool and
the tiers (connector.py). Keys, values and the wire are the JAX
package's, so engines of both packages share tiers; nothing here
imports either JAX or the JAX package.
"""
