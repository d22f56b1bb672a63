"""knn_tpu_torch.analysis — the byte model the join and the IVF tier read:
:mod:`~knn_tpu_torch.analysis.widths` (what one db row streams at each
precision) and :mod:`~knn_tpu_torch.analysis.hbm` (placement and query
block bytes, the join's superblock and sweep-nesting plan).  The copies of
knn_tpu/analysis/widths.py and knn_tpu/analysis/hbm.py the tiers need; the
rest of that package (the lint checkers, the artifact catalog) waits for
the second obs slice's last part (ROADMAP queue A item 5); the TPU's vmem
model has no counterpart (the tuner's Hopper resource gate stands in)."""
