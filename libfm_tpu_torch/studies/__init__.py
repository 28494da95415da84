"""The table probes of the JAX package's studies, ported: the same
functions under the same module names (`pallas_gather`, `pallas_scatter`),
each running one of the port's CUDA kernels. Nothing runs at import."""
