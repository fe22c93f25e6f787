"""Launchers: meshes over the process group's devices (:mod:`.mesh`) and
the training CLI (:mod:`.train`, ``python -m repro_torch.launch.train``)."""
