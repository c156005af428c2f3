from tpurec_torch.metrics.metrics import (
    auc_score,
    log_loss_score,
    evaluate_multi_domain,
    gauc_score,
    streaming_auc_bins,
    streaming_auc_from_bins,
    streaming_eval_result,
)
