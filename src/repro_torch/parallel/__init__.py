from .halo import HaloConv
