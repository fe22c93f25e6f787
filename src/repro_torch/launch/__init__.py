"""Launchers: meshes over the process group's devices (:mod:`.mesh`), the
training CLI (:mod:`.train`, ``python -m repro_torch.launch.train``) and the
dry run over the production meshes (:mod:`.specs`, :mod:`.dryrun`,
:mod:`.report`; ``python -m repro_torch.launch.dryrun``)."""
