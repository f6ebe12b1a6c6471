"""Entry points of the port: the LM serve step functions and the serve CLI
(``python -m repro_torch.launch.serve``)."""
