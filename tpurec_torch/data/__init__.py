"""Data utilities of the port: feature hashing, the synthetic multi-domain
dataset, batching and split statistics (numpy only)."""

from tpurec_torch.data.hashing import apply_hash_trick, hash_ids
from tpurec_torch.data.synthetic import SyntheticMultiDomain, make_synthetic
