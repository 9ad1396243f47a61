"""Hand-written CUDA kernels (built with nvcc at first use) + their formats.

Every kernel module holds the wrapper, the plain PyTorch version of the same
function and a launch counter; a CPU tensor takes the plain version, a CUDA
tensor the kernel.
"""
from .formats import (EdgeTileFormat, BsrFormat, build_edge_tiles, build_bsr,
                      pad_edge_tile_blocks)
from .ops import (DeviceEdgeTiles, DeviceBsr, power_step, edge_spmv, bsr_spmv,
                  seg_mm)
from . import ref

__all__ = ["EdgeTileFormat", "BsrFormat", "build_edge_tiles", "build_bsr",
           "pad_edge_tile_blocks", "DeviceEdgeTiles", "DeviceBsr",
           "power_step", "edge_spmv", "bsr_spmv", "seg_mm", "ref"]
