"""repro_torch.roofline -- the roofline model terms the search scores
with and the dry-run's table (``analysis``), and the op counts of a
traced step (``op_count``, the counterpart of the reference's
``hlo_parse``)."""
