"""optixpathtracer — a JAX wavefront path-tracing framework.

A ground-up JAX/XLA re-design of the capabilities of
bipul-mohanto/OptixPathTracer (OptiX 7.5/CUDA): progressive, interactive,
foveated Monte-Carlo path tracing — with the hardware BVH replaced by an
on-device LBVH + wavefront traversal, the megakernel replaced by an SoA
wavefront loop, and multi-GPU tile scaffolding replaced by shard_map over a
device mesh. On an NVIDIA GPU, traversal runs in a per-ray CUDA kernel
(ops/traverse_gpu.py); on the CPU, in the lockstep loop (ops/traverse.py).
"""

__version__ = "0.1.0"
