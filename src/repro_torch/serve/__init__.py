"""Serving substrate: batched continuous-decode engine with KV caches."""

from .engine import EngineStallError, Request, ServeConfig, ServeEngine

__all__ = ["EngineStallError", "Request", "ServeConfig", "ServeEngine"]
