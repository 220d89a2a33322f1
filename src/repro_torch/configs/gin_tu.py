"""gin-tu [arXiv:1810.00826]: 5 layers, d_hidden=64, sum aggregator,
learnable eps.  d_in/n_classes resolve per input shape (Cora-like /
Reddit-like / ogbn-products-like / molecules)."""
from repro_torch.configs.base import GNNArch
from repro_torch.models.gnn.gin import GINConfig

CFG = GINConfig(name="gin-tu", n_layers=5, d_hidden=64, learn_eps=True)
ARCH = GNNArch(CFG)
