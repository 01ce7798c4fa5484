"""Synthesizer-side (frontend) components.

The reference's frontend is TypeScript: EVM replay -> placements, plus
circom-WASM witness calculators per placement
(`packages/frontend/synthesizer/core/src/circuitGenerator/
handlers/variableGenerator.ts:33,88,356`).  This package hosts the
Python-native equivalents: a WASM->Python translator for the shipped
subcircuit witness calculators (wasm_vm.py, witness_calculator.py) so
witness generation is exact without a JS/WASM runtime.

The port's copy of the JAX package's `frontend/` (host Python on Python
ints there too; the port imports nothing of that package).  No part of it
touches a tensor.
"""
