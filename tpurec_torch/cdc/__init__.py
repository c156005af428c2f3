"""The CDC engine of the port (counterpart of ``tpurec/cdc``): the
host-side clustering algorithm (:mod:`.algorithm`) and the trainer that
populates its matrices on the card (:mod:`.engine`)."""

from tpurec_torch.cdc.algorithm import (
    CDCClusterState,
    calc_causal_matrix,
    calc_domain_lambda_in_group,
    kmeans_group,
    update_group,
)
from tpurec_torch.cdc.engine import CDCTrainer
