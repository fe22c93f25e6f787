"""The optimiser: AdamW (:mod:`.adamw`), learning-rate schedules
(:mod:`.schedule`) and int8 gradient compression with error feedback
(:mod:`.grad_compress`), in plain PyTorch."""
