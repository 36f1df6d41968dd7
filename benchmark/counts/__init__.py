"""Bytes and operations of the port's work, computed from a model's shapes
(one module a model family)."""
