"""ACAI CLI (§3.4): every SDK service gets a command.

    python -m repro_torch.core.cli --root <dir> --token <tok> <command> ...

Commands: upload, download, ls, create-file-set, submit, status, wait,
logs, jobs, cluster, find, trace. ``cluster`` renders the per-pool view
(capacity/utilization/placement counts per accelerator pool) and
``submit --pool`` pins a job to one pool. State persists under --root
(tokens in tokens.json for this local deployment). ``submit`` runs a
``module:callable`` through the futures SDK and prints the job id.
Job state persists to the metadata store and log text to the data lake
(``/.logs/<job-id>.log``), and each project engine journals its full
state under ``<root>/<project>/state`` (the durable control plane): a
fresh invocation *recovers* the registry, so ``status``/``wait``/
``logs <job-id>`` are first-class across processes — jobs an
interrupted invocation left non-terminal re-queue and complete on
recovery instead of stranding. ``--after`` accepts parents from past
invocations too — a FINISHED parent is a met dependency, a failed one
refuses the submit.

A copy of ``repro/core/cli.py``, with its imports in ``repro_torch.core``
and ``--root`` defaulting to ``acai-cli`` in the temporary directory
(``tempfile.gettempdir()``) rather than the reference's fixed
``/tmp/acai-cli``, so that runs with a ``TMPDIR`` of their own do not share
one platform's tokens and journals."""
from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import tempfile
from pathlib import Path

from repro_torch.core.acai import AcaiPlatform
from repro_torch.core.engine.handle import JobHandle
from repro_torch.core.engine.registry import JobSpec


def _load_platform(root: Path) -> AcaiPlatform:
    plat = AcaiPlatform(root, durable=True)
    tok_file = root / "tokens.json"
    if tok_file.exists():
        saved = json.loads(tok_file.read_text())
        plat._admin_token = saved["admin"]
        from repro_torch.core.acai import User
        for tok, u in saved["users"].items():
            plat._users[tok] = User(**u)
        for name in saved["projects"]:
            if name not in plat._projects:
                from repro_torch.core.acai import AcaiEngine, AcaiProject
                plat._projects[name] = AcaiProject(name, root / name)
                # durable engine over the project's journaled state:
                # jobs from past invocations recover into the registry,
                # making status/wait/logs first-class cross-process
                plat._engines[name] = AcaiEngine(
                    datalake=plat._projects[name],
                    workroot=str(root / name / "jobs"),
                    durable=root / name / "state")
    return plat


def _save_platform(plat: AcaiPlatform, root: Path) -> None:
    import dataclasses
    (root / "tokens.json").write_text(json.dumps({
        "admin": plat._admin_token,
        "users": {t: dataclasses.asdict(u)
                  for t, u in plat._users.items()},
        "projects": sorted(plat._projects),
    }))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="acai")
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "acai-cli"))
    ap.add_argument("--token", default=None)
    sub = ap.add_subparsers(dest="cmd", required=True)

    sp = sub.add_parser("init", help="create a project; prints admin token")
    sp.add_argument("project")

    sp = sub.add_parser("upload")
    sp.add_argument("path")
    sp.add_argument("file")

    sp = sub.add_parser("download")
    sp.add_argument("ref")

    sub.add_parser("ls")

    sp = sub.add_parser("create-file-set")
    sp.add_argument("name")
    sp.add_argument("specs", nargs="+")

    sp = sub.add_parser("submit", help="submit a job; prints id + state")
    sp.add_argument("name")
    sp.add_argument("--fn", required=True,
                    help="module:callable executed as the job program")
    sp.add_argument("--input-fileset", default=None)
    sp.add_argument("--output-fileset", default=None)
    sp.add_argument("--after", default="",
                    help="comma-separated parent job ids (DAG gating)")
    sp.add_argument("--arg", action="append", default=[],
                    metavar="K=V", help="job arg (JSON values accepted)")
    sp.add_argument("--vcpu", type=float, default=1)
    sp.add_argument("--mem-mb", type=float, default=512)
    sp.add_argument("--pool", default=None,
                    help="pin to one accelerator pool (requires a pools "
                         "deployment; see the `cluster` command)")
    sp.add_argument("--resource", action="append", default=[],
                    metavar="DIM=AMOUNT",
                    help="resource shape overriding --vcpu/--mem-mb "
                         "(repeatable; e.g. --resource chips=8 for a "
                         "TPU pool)")
    sp.add_argument("--no-wait", action="store_true",
                    help="print the handle immediately, don't resolve it")

    for c, h in (("status", "job state"), ("logs", "job log text"),
                 ("wait", "block until the job is terminal")):
        sp = sub.add_parser(c, help=h)
        sp.add_argument("job_id")
        if c == "wait":
            sp.add_argument("--timeout", type=float, default=None)

    sp = sub.add_parser("jobs")
    sp.add_argument("--status", default=None)
    sp.add_argument("--sort-by", default="job_id")

    sub.add_parser("cluster",
                   help="per-pool capacity/utilization/placement + "
                        "queue-wait metrics")

    sp = sub.add_parser("find")
    sp.add_argument("conditions", nargs="+",
                    help="key=value or key>value / key<value")

    sp = sub.add_parser("trace")
    sp.add_argument("fileset_ref", nargs="?")
    sp.add_argument("--forward", action="store_true")

    args = ap.parse_args(argv)
    root = Path(args.root)
    root.mkdir(parents=True, exist_ok=True)
    plat = _load_platform(root)

    if args.cmd == "init":
        tok = plat.create_project(plat.admin_token, args.project)
        _save_platform(plat, root)
        print(tok)
        return 0

    if not args.token:
        print("--token required", file=sys.stderr)
        return 2
    proj = plat.project(args.token)
    user = plat.authenticate(args.token)

    if args.cmd == "upload":
        ref = proj.upload(args.path, Path(args.file).read_bytes(),
                          creator=user.name)
        print(ref)
    elif args.cmd == "download":
        sys.stdout.buffer.write(proj.storage.download(args.ref))
    elif args.cmd == "ls":
        for p in proj.storage.list_files():
            print(f"{p}  versions={proj.storage.versions(p)}")
        for s in proj.filesets.list_sets():
            print(f"@{s}  versions="
                  f"{[v.version for v in proj.filesets._sets[s]]}")
    elif args.cmd == "create-file-set":
        print(proj.create_file_set(args.name, args.specs,
                                   creator=user.name))
    elif args.cmd == "submit":
        mod, _, fn_name = args.fn.partition(":")
        fn = getattr(importlib.import_module(mod), fn_name)
        job_args = {}
        for kv in args.arg:
            k, _, v = kv.partition("=")
            try:
                v = json.loads(v)
            except json.JSONDecodeError:
                pass
            job_args[k] = v
        # the registry is per-process (each invocation submits one job),
        # so --after is a pre-submit gate over persisted terminal state;
        # in-process scheduler gating needs the ROADMAP's persistent
        # registry
        for pid in [j for j in args.after.split(",") if j]:
            past = proj.metadata.get(pid).get("state")
            if past == "FINISHED":
                continue
            if past is None:
                print(f"unknown parent job {pid}", file=sys.stderr)
            else:
                print(f"refusing submit: parent {pid} ended {past}",
                      file=sys.stderr)
            return 1
        if args.pool and plat.engine(args.token).scheduler.placement \
                is None:
            # silently dropping the pin would run the job anywhere
            print(f"--pool {args.pool} requires a pools deployment; "
                  f"this engine has no placement layer", file=sys.stderr)
            return 2
        resources = {"vcpu": args.vcpu, "mem_mb": args.mem_mb}
        if args.resource:
            resources = {}
            for kv in args.resource:
                k, sep, v = kv.partition("=")
                try:
                    if not (k and sep):
                        raise ValueError
                    resources[k] = float(v)
                except ValueError:
                    print(f"--resource expects DIM=AMOUNT with a numeric "
                          f"amount, got {kv!r}", file=sys.stderr)
                    return 2
        handle = plat.submit_job(args.token, JobSpec(
            name=args.name, project="", user="", fn=fn,
            input_fileset=args.input_fileset,
            output_fileset=args.output_fileset,
            args=job_args, pool=args.pool, resources=resources))
        state = handle.status() if args.no_wait else handle.wait()
        print(f"{handle.job_id} {state.value}")
    elif args.cmd in ("status", "wait", "logs"):
        # cancel is SDK-only (JobHandle.cancel): the registry is
        # per-process, so by the time a second invocation could cancel,
        # the job is already terminal
        eng = plat.engine(args.token)
        in_registry = True
        try:
            job = eng.registry.get(args.job_id)
        except KeyError:
            in_registry = False
        if args.cmd == "logs":
            log = job.outputs.get("log") if in_registry else None
            if log is None:
                # the agent persists log text to the data lake
                try:
                    log = proj.storage.download(
                        f"/.logs/{args.job_id}.log").decode()
                except Exception:
                    log = None
            if log is None:
                if not in_registry and not proj.metadata.get(args.job_id):
                    print(f"unknown job {args.job_id}", file=sys.stderr)
                    return 1
                log = ""
            sys.stdout.write(log)
        elif in_registry:
            h = JobHandle(job, eng)
            state = h.wait(args.timeout) if args.cmd == "wait" \
                else h.status()
            line = state.value
            if args.cmd == "status":
                # answer "why" without a second lookup: retry count and
                # last failure reason ride the status line
                if job.retries:
                    line += f" retries={job.retries}"
                if job.error:
                    why = str(job.error).strip().splitlines()[-1][:120]
                    line += f" error={why}"
            print(line)
        else:
            # past invocation: the registry is per-process, read metadata
            doc = proj.metadata.get(args.job_id)
            if not doc:
                print(f"unknown job {args.job_id}", file=sys.stderr)
                return 1
            state = doc.get("state")
            if state is None:
                # registered but no terminal state persisted: submitted by
                # an interrupted or still-running invocation
                if args.cmd == "wait":
                    print(f"{args.job_id} has no terminal state recorded "
                          f"(owning process interrupted or still running)",
                          file=sys.stderr)
                    return 1
                state = "SUBMITTED"
            line = state
            if args.cmd == "status":
                if doc.get("retries"):
                    line += f" retries={doc['retries']}"
                if doc.get("error"):
                    line += f" error={doc['error']}"
            print(line)
    elif args.cmd == "jobs":
        from repro_torch.core.engine.dashboard import job_history
        eng = plat.engine(args.token)
        print(job_history(eng.registry, proj.metadata,
                          status=args.status, sort_by=args.sort_by))
    elif args.cmd == "cluster":
        from repro_torch.core.engine.dashboard import scheduler_page
        eng = plat.engine(args.token)
        print(scheduler_page(eng.scheduler, eng.monitor))
    elif args.cmd == "find":
        conds = {}
        for c in args.conditions:
            if ">" in c:
                k, v = c.split(">", 1)
                conds[k] = (">", float(v))
            elif "<" in c:
                k, v = c.split("<", 1)
                conds[k] = ("<", float(v))
            else:
                k, v = c.split("=", 1)
                try:
                    v = float(v)
                except ValueError:
                    pass
                conds[k] = v
        for aid in proj.metadata.find(**conds):
            print(aid, json.dumps({k: v for k, v in
                                   proj.metadata.get(aid).items()
                                   if v is not None}))
    elif args.cmd == "trace":
        from repro_torch.core.engine.dashboard import provenance_page
        print(provenance_page(
            proj.provenance, args.fileset_ref,
            direction="forward" if args.forward else "backward"))
    _save_platform(plat, root)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
