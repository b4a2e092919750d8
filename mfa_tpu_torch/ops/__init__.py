"""Descriptors, precision policy, parameter tables, kernel cache, public entry points."""
