"""repro_torch.roofline -- the roofline model terms the search scores with
(``analysis``)."""
