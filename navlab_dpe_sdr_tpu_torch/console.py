"""Interactive console: flow management shell.

The reference drives CUDARecv through a readline console with
prefix-abbreviated commands (NEWFlow/DELFlow/STARTFlow/STOPFlow/LOADFlow/
ADDAlias/ACTFlow/SETParam/LSFlow/PRINTport + Quit/HIStory/HELp/DOfile,
cmdParser.cpp:28-46, cmdFlow.cpp:21-32) plus nested `dofile` scripts, and
runs each flow on its own thread with stop/join semantics (flow.cu:89-103).
Same surface here over the DPE receiver:

  newflow <name> <capture> <handoff>     create a flow
  loadflow <name> <params.json>          load DPEConfig overrides from JSON
  setparam [<name>] <key> <value>        DPEConfig override (pre-start)
  startflow [<name>] [blocks] [&]        run it (& = background thread)
  stopflow [<name> ...]                  stop a running background flow
  delflow <name> ...                     stop + delete flows
  lsflow                                 list flows and their state
  addalias <name> <alias>                alternate name for a flow
  actflow <name>                         set the default (active) flow
  status [<name>]                        fixes/stats so far
  printport [<name>] <attr>              peek receiver state (rc/fi/x/...)
  history                                show command history
  dofile <script>                        run commands from a file
  quit

Any unambiguous command prefix is accepted (e.g. `startf`, `lsf`, `q`).

The port's console (the JAX package's navlab_dpe_sdr_tpu/console.py over
the port's DPEReceiver): `Console(device=...)` builds every flow's
receiver on that device (default "cuda"; a missing card raises when a flow
starts). Background flows launch kernels from their own threads; the
launch counter and the scorer's scratch are locked for that
(ops/_build.count_launch, ops/score._scratch_lock).
"""

from __future__ import annotations

import cmd
import json
import shlex
import threading

import numpy as np


class _Flow:
    def __init__(self, capture, handoff_path, device="cuda"):
        self.capture = capture
        self.device = device
        self.handoff_path = handoff_path
        self.overrides = {}
        self.rx = None
        self.stats = None
        self.runner = None
        self.thread: threading.Thread | None = None
        self.error: Exception | None = None

    @property
    def running(self) -> bool:
        return self.thread is not None and self.thread.is_alive()

    def build(self):
        from .io.handoff import read_handoff
        from .io.rawfile import SampleFile
        from .models.dpe import DPEConfig, DPEReceiver

        hand = read_handoff(self.handoff_path)
        rf = SampleFile(self.capture, fs=float(self.overrides.get("fs", 2.5e6)))
        cfg_fields = {k: v for k, v in self.overrides.items()
                      if k in DPEConfig.__dataclass_fields__}
        self.rx = DPEReceiver(rf, hand, config=DPEConfig(**cfg_fields),
                              device=self.device)
        return self.rx


class Console(cmd.Cmd):
    intro = ("navlab_dpe_sdr_tpu_torch console. Commands: newflow loadflow "
             "setparam startflow stopflow delflow lsflow addalias actflow "
             "status printport history dofile quit (unambiguous prefixes ok)")
    prompt = "dpe> "

    def __init__(self, device="cuda", **kw):
        super().__init__(**kw)
        self.device = device
        self.flows: dict[str, _Flow] = {}
        self.aliases: dict[str, str] = {}
        self.active: str | None = None
        self.history: list[str] = []

    def _say(self, *args):
        print(*args, file=self.stdout)

    # -- dispatch helpers --------------------------------------------------

    def precmd(self, line):
        if line.strip():
            self.history.append(line)
        return line

    def default(self, line):
        """Resolve unambiguous command prefixes (reference regCmd minimal
        abbreviations, cmdParser.cpp:28-40 — here any unique prefix)."""
        tok = line.split()[0]
        rest = line[len(tok):].lstrip()
        names = sorted({n[3:] for n in self.get_names()
                        if n.startswith("do_") and n != "do_EOF"})
        matches = [n for n in names if n.startswith(tok.lower())]
        if len(matches) == 1:
            return self.onecmd(f"{matches[0]} {rest}".strip())
        if matches:
            self._say(f"ambiguous command {tok!r}: {' '.join(matches)}")
        else:
            self._say(f"unknown command: {tok}")

    # -- tab completion (the reference scaffolds completion hooks in its
    # line editor, cmdReader.cpp; here the cmd module drives them) ---------

    def completenames(self, text, *ignored):
        names = sorted({n[3:] for n in self.get_names()
                        if n.startswith("do_") and n != "do_EOF"})
        return [n + " " for n in names if n.startswith(text.lower())]

    def _complete_flow(self, text):
        pool = sorted(set(self.flows) | set(self.aliases))
        return [n + " " for n in pool if n.startswith(text)]

    def complete_startflow(self, text, line, begidx, endidx):
        return self._complete_flow(text)

    complete_stopflow = complete_startflow
    complete_delflow = complete_startflow
    complete_actflow = complete_startflow
    complete_addalias = complete_startflow
    complete_status = complete_startflow
    complete_printport = complete_startflow
    complete_loadflow = complete_startflow

    def complete_setparam(self, text, line, begidx, endidx):
        from .models.dpe import DPEConfig
        keys = sorted(DPEConfig.__dataclass_fields__) + ["watchdog", "fs"]
        return (self._complete_flow(text)
                + [k + " " for k in keys if k.startswith(text)])

    def _flow(self, name: str | None):
        """Look up a flow by name or alias; None/'' -> the active flow."""
        if not name:
            name = self.active
            if not name:
                self._say("no flow named (and no active flow set)")
                return None, None
        name = self.aliases.get(name, name)
        fl = self.flows.get(name)
        if not fl:
            self._say(f"no flow {name}")
        return name, fl

    def _report(self, name, fl):
        if fl.error is not None:
            self._say(f"flow {name} failed: {fl.error}")
            return
        if fl.stats is not None:
            self._say(fl.stats.summary())
        if fl.rx is not None and fl.rx.fixes:
            self._say(f"final fix {fl.rx.fixes[-1].x_ecef[:3]}")

    # -- commands ----------------------------------------------------------

    def do_newflow(self, line):
        """newflow <name> <capture.dat> <handoff.csv>"""
        try:
            name, capture, handoff = shlex.split(line)
        except ValueError:
            self._say("usage: newflow <name> <capture> <handoff>")
            return
        self.flows[name] = _Flow(capture, handoff, self.device)
        if self.active is None:
            self.active = name
        self._say(f"flow {name} created")

    def do_loadflow(self, line):
        """loadflow <flow> <params.json> — bulk DPEConfig overrides
        (reference LOADFlow settings file, cmdFlow.cpp:91-107)"""
        try:
            name, path = shlex.split(line)
        except ValueError:
            self._say("usage: loadflow <flow> <params.json>")
            return
        name, fl = self._flow(name)
        if not fl:
            return
        try:
            with open(path) as fo:
                params = json.load(fo)
        except (OSError, json.JSONDecodeError) as e:
            self._say(f"loadflow: {e}")
            return
        fl.overrides.update(params)
        self._say(f"{name}: loaded {len(params)} params from {path}")

    def do_setparam(self, line):
        """setparam [<flow>] <key> <value>  (DPEConfig fields, pre-start)"""
        parts = shlex.split(line)
        if len(parts) == 2:
            parts = [""] + parts
        if len(parts) != 3:
            self._say("usage: setparam [<flow>] <key> <value>")
            return
        name, key, value = parts
        name, fl = self._flow(name)
        if not fl:
            return
        for cast in (int, float):
            try:
                value = cast(value)
                break
            except ValueError:
                continue
        fl.overrides[key] = value
        self._say(f"{name}.{key} = {value}")

    def do_startflow(self, line):
        """startflow [<flow>] [n_blocks] [&] — & runs in the background
        (stop with stopflow; reference Flow::Start, flow.cu:70-87)"""
        parts = shlex.split(line)
        background = bool(parts) and parts[-1] == "&"
        if background:
            parts = parts[:-1]
        name = parts[0] if parts and not parts[0].isdigit() else ""
        nums = [p for p in parts if p.isdigit()]
        n = int(nums[0]) if nums else 100
        name, fl = self._flow(name)
        if not fl:
            return
        if fl.running:
            self._say(f"flow {name} is already running")
            return
        from .runtime.flow import FlowRunner
        try:
            rx = fl.build()
        except Exception as e:
            self._say(f"startflow: {e}")
            return
        fl.error = None
        # Reference flows always enforce the 1.5 s per-block watchdog
        # (README.md:108, sampleblock.cu:432-447); same default here, with
        # `setparam watchdog <seconds>` as the escape hatch (<=0 disables).
        # The first iteration gets grace: that is where the device context
        # and kernel loads land, which the reference pays in Start().
        wd = float(fl.overrides.get("watchdog", 1.5))
        fl.runner = FlowRunner(rx.step, watchdog_s=wd if wd > 0 else None,
                               max_iterations=n, warmup_iterations=1)

        def _run():
            try:
                fl.stats = fl.runner.run(n)
            except Exception as e:   # pragma: no cover - surfaced via status
                fl.error = e

        fl.thread = threading.Thread(target=_run, daemon=True,
                                     name=f"flow-{name}")
        fl.thread.start()
        if background:
            self._say(f"flow {name} started")
        else:
            fl.thread.join()
            self._report(name, fl)

    def do_stopflow(self, line):
        """stopflow [<flow> ...] — stop running background flows
        (reference Flow::Stop, flow.cu:89-103)"""
        names = shlex.split(line) or [""]
        for raw in names:
            name, fl = self._flow(raw)
            if not fl:
                continue
            if not fl.running:
                self._say(f"flow {name} wasn't running")
                continue
            fl.runner.stop()
            fl.thread.join()
            self._say(f"flow {name} stopped after "
                      f"{fl.runner.stats.n} iterations")
            self._report(name, fl)

    def do_delflow(self, line):
        """delflow <flow> ... — stop and delete flows"""
        names = shlex.split(line)
        if not names:
            self._say("usage: delflow <flow> ...")
            return
        for raw in names:
            name, fl = self._flow(raw)
            if not fl:
                continue
            if fl.running:
                fl.runner.stop()
                fl.thread.join()
            del self.flows[name]
            self.aliases = {a: t for a, t in self.aliases.items() if t != name}
            if self.active == name:
                self.active = next(iter(self.flows), None)
            self._say(f"flow {name} deleted")

    def do_lsflow(self, line):
        """lsflow — list flows and their state"""
        if not self.flows:
            self._say("no flows")
            return
        for name, fl in self.flows.items():
            state = ("running" if fl.running
                     else "failed" if fl.error is not None
                     else "done" if fl.stats is not None else "new")
            marks = [a for a, t in self.aliases.items() if t == name]
            alias_s = f" aliases={','.join(marks)}" if marks else ""
            act = " *" if name == self.active else ""
            self._say(f"{name}{act}: {state} capture={fl.capture}"
                      f"{alias_s} overrides={fl.overrides}")

    def do_addalias(self, line):
        """addalias <flow> <alias> (reference ADDAlias, cmdFlow.cpp:110-123)"""
        try:
            name, alias = shlex.split(line)
        except ValueError:
            self._say("usage: addalias <flow> <alias>")
            return
        name, fl = self._flow(name)
        if not fl:
            return
        self.aliases[alias] = name
        self._say(f"{alias} -> {name}")

    def do_actflow(self, line):
        """actflow <flow> — set the active (default) flow"""
        name, fl = self._flow(line.strip())
        if fl:
            self.active = name
            self._say(f"active flow: {name}")

    def do_status(self, line):
        """status [<flow>]"""
        names = [line.strip()] if line.strip() else list(self.flows)
        for raw in names:
            name, fl = self._flow(raw)
            if not fl:
                continue
            n = len(fl.rx.fixes) if fl.rx else 0
            state = "running" if fl.running else "idle"
            self._say(f"{name}: {state} capture={fl.capture} fixes={n} "
                      f"overrides={fl.overrides}")
            if fl.error is not None:
                self._say(f"  error: {fl.error}")

    def do_printport(self, line):
        """printport [<flow>] <attr> — peek receiver state (rc, fi, cp, x...)"""
        parts = shlex.split(line)
        if len(parts) == 1:
            parts = [""] + parts
        if len(parts) != 2:
            self._say("usage: printport [<flow>] <attr>")
            return
        name, fl = self._flow(parts[0])
        if not fl:
            return
        if fl.rx is None:
            self._say("flow not started")
            return
        attr = parts[1]
        target = fl.rx.ekf.x if attr == "x" else getattr(fl.rx, attr, None)
        if target is None:
            self._say(f"no attribute {attr}")
        else:
            self._say(np.asarray(target))

    def do_history(self, line):
        """history — show command history (reference HIStory cmdCommon.cpp)"""
        for i, entry in enumerate(self.history):
            self._say(f"{i:4d}  {entry}")

    def do_dofile(self, line):
        """dofile <script> — execute console commands from a file"""
        try:
            with open(line.strip()) as fo:
                for cmdline in fo:
                    cmdline = cmdline.strip()
                    if cmdline and not cmdline.startswith("#"):
                        self._say(f"{self.prompt}{cmdline}")
                        self.history.append(cmdline)
                        if self.onecmd(cmdline):
                            return True
        except OSError as e:
            self._say(e)

    def do_quit(self, line):
        """quit — stop any running flows and exit"""
        for name, fl in self.flows.items():
            if fl.running:
                fl.runner.stop()
                fl.thread.join()
                self._say(f"flow {name} stopped")
        return True

    do_EOF = do_quit


def main(device="cuda"):
    Console(device=device).cmdloop()


if __name__ == "__main__":
    main()
