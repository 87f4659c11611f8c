"""Kernel wrappers, their plain twins, and the field/curve/scan layers."""
