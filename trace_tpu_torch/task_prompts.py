"""Task prompt strings (data, not code).

The port's copy of ``trace_tpu/task_prompts.py``.

These are the exact task instructions the released TRACE checkpoints were
evaluated with (reference: trace/prompts/{dvc,dvc-anet,dvc-anet-ft,mr,vhd}.txt
— eval results are prompt-sensitive, so the wording must match verbatim).
``mr`` and ``vhd`` are format strings taking the text query.
"""

TASK_PROMPTS = {
    "dvc": (
        "Examine the video and locate a number of events, stating their "
        "commencement and completion timestamps and a succinct explanation."
    ),
    "dvc-anet": (
        "Pinpoint the time intervals of activity events in the video, and "
        "provide detailed descriptions for each event."
    ),
    "dvc-anet-ft": (
        "Localize a series of activity events in the video, output the start "
        "and end timestamp for each event, and describe each event with "
        "sentences. The output format of each predicted event should be "
        "like: 'start - end seconds, event description'. A specific example "
        "is: ' 90 - 102 seconds, spread margarine on two slices of white "
        "bread in the video'."
    ),
    "mr": (
        "Localize the visual content described by the given textual query "
        "'{}' in the video, and output the start and end timestamps in "
        "seconds."
    ),
    "vhd": (
        "Please find the highlight contents in the video described by a "
        "sentence query, determining the highlight timestamps and its "
        "saliency score on a scale from 1 to 5. Now I will give you the "
        "sentence query: '{}'. Please return the query-based highlight "
        "timestamps and salient scores."
    ),
}

# eval-task name -> prompt key (tvg uses the moment-retrieval prompt)
TASK_TO_PROMPT = {
    "dvc": "dvc",
    "dvc-anet": "dvc-anet",
    "dvc-anet-ft": "dvc-anet-ft",
    "tvg": "mr",
    "vhd": "vhd",
}


def get_task_prompt(task: str) -> str:
    return TASK_PROMPTS[TASK_TO_PROMPT[task]]
