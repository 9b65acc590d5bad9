"""Examples of the port, importable as ``metafem_torch.examples``."""
