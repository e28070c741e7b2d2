"""Launchers: the serving CLI (:mod:`repro_torch.launch.serve`), the
training launcher (:mod:`repro_torch.launch.train`), meshes
(:mod:`repro_torch.launch.mesh`), the dry-run and the hillclimb."""
