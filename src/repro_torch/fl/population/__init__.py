"""Client populations, cohort sampling and per-client state (port of
``repro.fl.population``, the materialised half)."""

from repro_torch.fl.population.base import (  # noqa: F401
    ClientPopulation,
    MaterializedPopulation,
    as_population,
)
from repro_torch.fl.population.sampling import (  # noqa: F401
    client_round_seed,
    resolve_cohort_size,
    sample_without_replacement,
)
from repro_torch.fl.population.store import ClientStateStore  # noqa: F401
