from repro_torch.fl.algorithms import AlgoConfig  # noqa: F401
from repro_torch.fl.batched import (ENGINES, SequentialEngine,  # noqa: F401
                                    VmapEngine, make_engine)
from repro_torch.fl.client import LocalTrainer  # noqa: F401
from repro_torch.fl.population import (ClientPopulation,  # noqa: F401
                                       ClientStateStore, MaterializedPopulation,
                                       SyntheticPopulation, as_population)
from repro_torch.fl.runtime import (AvailabilityConfig,  # noqa: F401
                                    ClientAvailability, run_federated_async)
from repro_torch.fl.server import (RUNTIMES, FLResult, FLRunConfig,  # noqa: F401
                                   run_federated)
from repro_torch.fl.tasks import TaskAdapter, nlp_task, resnet_task  # noqa: F401
