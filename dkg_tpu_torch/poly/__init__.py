"""Batched polynomial evaluation over limb tensors."""
