from repro_torch.data.synthetic import (  # noqa: F401
    TextDatasetSpec,
    VisionDatasetSpec,
    make_text_dataset,
    make_vision_dataset,
)
from repro_torch.data.partitioner import (  # noqa: F401
    dirichlet_partition,
    iid_partition,
    partition_stats,
)
from repro_torch.data.pipeline import (  # noqa: F401
    ClientDataset,
    StackedClientBatches,
    balanced_eval_set,
    batch_plan,
    bucket_plans,
    build_clients,
    stack_client_batches,
)
