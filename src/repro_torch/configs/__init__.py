from repro_torch.configs.registry import ARCH_IDS, get_config, list_archs  # noqa: F401
