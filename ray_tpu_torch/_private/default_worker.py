"""Worker process entry point.

The port's own copy of `ray_tpu/_private/default_worker.py`: connect to
the head, then block in the task-execution loop. The head starts it as

    python -m ray_tpu_torch._private.default_worker \\
        --head-sock <addr> --session-dir <dir> --session-name <name>

with the driver's `sys.path` in `PYTHONPATH`. It imports torch, numpy
and `ray_tpu_torch` only as the tasks it runs need them.
"""

import argparse
import logging
import os


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--head-sock", required=True)
    parser.add_argument("--session-dir", required=True)
    parser.add_argument("--session-name", required=True)
    args = parser.parse_args()
    logging.basicConfig(
        level=logging.WARNING,
        format=f"[worker {os.getpid()}] %(levelname)s %(name)s: "
               "%(message)s")

    from ray_tpu_torch._private import worker_state
    from ray_tpu_torch._private.runtime import Runtime

    rt = Runtime(args.session_dir, args.session_name,
                 args.head_sock.replace("\\0", "\0"), role="worker")
    worker_state.set_runtime(rt, worker_state.WORKER_MODE)
    # Tasks run only once the process-global runtime is set: a task may
    # call the ray_tpu_torch API.
    rt.start_task_loop()
    rt.run_worker_loop()


if __name__ == "__main__":
    main()
