"""Training: the step (:mod:`.train_step`), checkpoints
(:mod:`.checkpoint`), fault tolerance (:mod:`.ft`) and the driver
(:mod:`.trainer`), in plain PyTorch."""
