"""Traffic generators, one module a kind: ``<kind>.py`` defines
``build(cfg, mix, seed, device)``, whose object has ``warm()``,
``step(k)`` (one closed-loop step of the window: its record),
``free()`` (drop the program's state) and ``check(records, control)``.
A mix's parameters are a data file, ``<mix>.json``, beside them."""
