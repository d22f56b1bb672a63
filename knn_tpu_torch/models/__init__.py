"""knn_tpu_torch.models — see the modules for their knn_tpu counterparts."""
