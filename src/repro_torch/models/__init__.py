from repro_torch.models.model import Model, init_cache  # noqa: F401
