from .config import Flow, NetConfig
from .topology import FatTree, meta_fabric, paper_train_topo

__all__ = ["FatTree", "Flow", "NetConfig", "meta_fabric", "paper_train_topo"]
