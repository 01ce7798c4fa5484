"""Adapters from the generator's plain data to the program's entry points."""
