from .config import Flow, NetConfig
from .topology import FatTree, paper_train_topo

__all__ = ["FatTree", "Flow", "NetConfig", "paper_train_topo"]
