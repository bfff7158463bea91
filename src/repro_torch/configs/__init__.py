from .base import (ARCH_IDS, LONG_CONTEXT_SKIP, SHAPES, ArchConfig,
                   ShapeConfig, cells, get_arch, registry, smoke)

__all__ = ["ARCH_IDS", "LONG_CONTEXT_SKIP", "SHAPES", "ArchConfig",
           "ShapeConfig", "cells", "get_arch", "registry", "smoke"]
