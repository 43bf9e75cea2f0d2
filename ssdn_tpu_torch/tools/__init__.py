"""Command-line tools of the port (``python -m ssdn_tpu_torch.tools.<name>``):
``export_pretrained`` (a workdir's checkpoint as a zoo artifact),
``blind_calibration`` (a variable-blind model's estimate against the true
noise level) and ``parity_check`` (the stabilized arm against the reference
objective)."""
