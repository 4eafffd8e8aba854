"""Serving stack of the port: paged KV cache, engine, local router."""
