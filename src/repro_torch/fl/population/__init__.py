"""Client populations, cohort sampling and per-client state (port of
``repro.fl.population``): cohorts sampled from millions of virtual clients
whose shards, speeds and tiers are functions of (seed, client_id), so host
memory and per-round work scale with the cohort, never the population."""

from repro_torch.fl.population.base import (  # noqa: F401
    ClientPopulation,
    MaterializedPopulation,
    as_population,
)
from repro_torch.fl.population.sampling import (  # noqa: F401
    IncrementalSampler,
    client_round_seed,
    resolve_cohort_size,
    sample_excluding,
    sample_without_replacement,
    weighted_sample_without_replacement,
)
from repro_torch.fl.population.store import ClientStateStore  # noqa: F401
from repro_torch.fl.population.synthetic import SyntheticPopulation  # noqa: F401
