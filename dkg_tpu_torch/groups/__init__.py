"""Curve points on 16-bit limbs: host oracle, batched tensor ops, fixed-base tables."""
