"""Node ops as plain functions on torch tensors.

Each module mirrors its namesake in `kanter_core_tpu/ops/`. The fused
evaluator (`kanter_core_tpu_torch.compiler`) calls the tensor functions
here; ops whose module is absent are not yet ported, and the evaluator
raises a `NODE_PROCESSING` error for their node kinds.
"""
