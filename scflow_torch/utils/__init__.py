"""Host-side utilities: flow visualisation, the TensorBoard event writer
with its PNG encoder, and profiling helpers."""
