from videocad_tpu_torch.qa.harness import (  # noqa: F401
    EvaluationPipeline,
    MockClient,
    ModelOutput,
    Option,
    QADataset,
    QAItem,
    RandomClient,
    create_client,
    recover_answer_id,
    template_accuracies,
)
from videocad_tpu_torch.qa.analysis import (  # noqa: F401
    eval_model_dir,
    group_outputs,
    load_all_outputs,
    majority_vote_accuracy,
)
