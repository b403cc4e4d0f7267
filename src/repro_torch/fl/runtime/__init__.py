"""The event-driven async runtime (port of ``repro.fl.runtime``): client
availability, aggregation policies, the server control loop and the event
loop that drives the engines' cohort backend on a virtual clock."""

from repro_torch.fl.runtime.clients import AvailabilityConfig, ClientAvailability  # noqa: F401
from repro_torch.fl.runtime.control import (CONTROLLERS,  # noqa: F401
                                            AdaptiveInflightController,
                                            CompositeController,
                                            ParticipationController,
                                            PlanAssignmentController,
                                            PolicyAdjustment,
                                            ProgressGroupController,
                                            ServerController,
                                            StalenessBufferController,
                                            make_controller)
from repro_torch.fl.runtime.engine import run_federated_async  # noqa: F401
from repro_torch.fl.runtime.policy import (POLICIES, AggregationPolicy,  # noqa: F401
                                           ClientUpdate, FedBuffPolicy,
                                           SyncFedAvgPolicy, make_policy)
