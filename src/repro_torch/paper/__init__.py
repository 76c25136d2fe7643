"""The paper's tables on the port: Tables 1-2, Fig 3 and the subdivision
sweep (the counterparts of the reference's ``benchmarks/paper_*.py`` and
``benchmarks/subdiv_sweep.py``).

Each script has ``run(..., device="cuda", executor="execute")`` and a
command line, ``python -m repro_torch.paper.table1 [--device cpu]
[--executor lower]``; the device is the card unless the CPU is asked for.
"""
