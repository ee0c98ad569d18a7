"""The training substrate: AdamW (``optimizer``), the train-step factory
(``train_step``), checkpoints (``checkpoint``), restart bookkeeping, the
elastic mesh and the straggler monitor (``fault_tolerance``), and the
tree helpers they share (``tree``)."""
