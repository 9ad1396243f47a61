from .registry import ShapeCfg, ArchEntry, get_arch, ARCHS, PORT_ARCHS

__all__ = ["ShapeCfg", "ArchEntry", "get_arch", "ARCHS", "PORT_ARCHS"]
