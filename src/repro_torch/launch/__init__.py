"""Launchers: the serving CLI (:mod:`repro_torch.launch.serve`) and the
single-device training launcher (:mod:`repro_torch.launch.train`)."""
