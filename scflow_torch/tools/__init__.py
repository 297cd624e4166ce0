"""Diagnostic scripts of the port, run on the GPU from a checkout's root."""
