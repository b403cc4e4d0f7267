from repro_torch.fl.algorithms import AlgoConfig  # noqa: F401
from repro_torch.fl.batched import (ENGINES, SequentialEngine,  # noqa: F401
                                    make_engine)
from repro_torch.fl.client import LocalTrainer  # noqa: F401
from repro_torch.fl.server import FLResult, FLRunConfig, run_federated  # noqa: F401
from repro_torch.fl.tasks import TaskAdapter, nlp_task, resnet_task  # noqa: F401
