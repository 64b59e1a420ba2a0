"""The serving engine: scheduler, runner, engine loop and HTTP server."""
