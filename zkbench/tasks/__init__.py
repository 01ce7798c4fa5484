"""Kinds of job, one module a kind, named by a configuration's `task`."""
