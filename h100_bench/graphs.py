"""The node count of a captured CUDA graph, read through the driver API
(`cuGraphGetNodes`): what one replay of a chunk asks the device to run."""
from __future__ import annotations

import ctypes


def graph_nodes(graph) -> int:
    """Nodes of a `torch.cuda.CUDAGraph` captured with keep_graph=True."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    lib.cuGraphGetNodes.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(graph.raw_cuda_graph(), None, ctypes.byref(count))
    if rc:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {rc})")
    return count.value
