"""Standalone probes of the port's kernels, each with its own entry
point (``python3 -m metafem_torch.benchmarks.<probe>``)."""
