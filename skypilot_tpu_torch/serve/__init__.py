"""Serving stack of the port: the paged continuous-batching engine and
its HTTP model server."""
