from .registry import ShapeCfg, ArchEntry, get_arch, ARCHS

__all__ = ["ShapeCfg", "ArchEntry", "get_arch", "ARCHS"]
