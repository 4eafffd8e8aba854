"""repro_torch.obs — observability.  This slice ports the task/span
recorder (:mod:`repro_torch.obs.trace`); export, sampling and analysis
follow with the multi-locality slice."""
