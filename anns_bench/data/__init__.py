"""Corpus and query generators, one module a ``generator.kind``."""
