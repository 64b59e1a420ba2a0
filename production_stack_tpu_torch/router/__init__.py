"""OpenAI-compatible L7 request router.

Capability parity with the reference router (reference: src/vllm_router/,
SURVEY.md §2.1) — service discovery (static + Kubernetes watch), routing
policies (round-robin, session consistent-hash, least-loaded, prefix
KV-affinity), engine/request stats planes, dynamic config hot-reload,
feature gates, files/batches APIs — re-designed as a single-event-loop
asyncio application (the reference mixes daemon threads with asyncio;
here every background activity is a cancellable asyncio task) on aiohttp
instead of FastAPI.
"""
