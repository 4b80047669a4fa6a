"""Utilities: state and fields carried across from the JAX package."""
