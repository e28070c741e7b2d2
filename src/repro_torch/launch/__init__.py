"""Launchers: the serving CLI (:mod:`repro_torch.launch.serve`)."""
