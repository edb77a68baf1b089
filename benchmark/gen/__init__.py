"""Input generators, one module a generator, named by a configuration's
``generator`` key.  Each gives ``positions(cfg, seed)`` and
``chunks(cfg, seed, n_sites, device)``: the genotype codes of the first
``n_sites`` sites in pieces of ``_common.CHUNK`` sites."""
