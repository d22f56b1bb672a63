"""knn_tpu_torch.ivf — see the modules for their knn_tpu counterparts."""
