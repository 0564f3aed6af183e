"""Pipeline GUI: run the trajectory / simulate / identify / visualize
stages of the port with file pickers, streaming output and state
persistence.

    python -m flobaroid_tpu_torch.cli.gui

Counterpart of the JAX package's root gui.py (the reference's
CustomTkinter app, gui.py:448-887) with the standard-library tkinter:
per-stage run buttons plus a full pipeline runner, ANSI-stripped
streaming subprocess output, UI state persisted to .gui_state.json,
graceful cancel, stdin passthrough to the running stage (interactive
prompts like the simulator's overwrite guard, reference gui.py:123-152)
and system sleep inhibition while a stage runs (caffeinate /
systemd-inhibit, reference gui.py:72-90). Each stage runs
`python -m flobaroid_tpu_torch.cli.<stage>`; the Device field is passed
as `--device` (empty: the commands' default, the card). The argument
lists are built by `stage_argv`, which needs no display.
"""

from __future__ import annotations

import json
import os
import queue
import re
import shutil
import subprocess
import sys
import threading

STATE_FILE = ".gui_state.json"
ANSI_RE = re.compile(r"\x1b\[[0-9;]*m")


def sleep_inhibit_prefix() -> list[str]:
    """Command prefix that keeps the machine awake for the duration of
    the wrapped stage: caffeinate on macOS, systemd-inhibit on Linux
    (reference gui.py:72-90). Empty when neither tool exists."""
    if sys.platform == "darwin" and shutil.which("caffeinate"):
        return ["caffeinate", "-dims"]
    if shutil.which("systemd-inhibit"):
        return [
            "systemd-inhibit", "--what=idle:sleep",
            "--why=flobaroid pipeline stage running",
        ]
    return []


def stage_argv(stage: str, fields: dict, python: str = sys.executable) -> list[str]:
    """The command line of one pipeline stage ('trajectory', 'simulator',
    'identifier' or 'visualizer') from the GUI's field values (keys of
    PipelineGUI.FIELDS; empty or missing optional fields are left out)."""
    def get(key):
        return (fields.get(key) or "").strip()

    argv = [python, "-m", f"flobaroid_tpu_torch.cli.{stage}",
            "--config", get("config"), "--model", get("model")]
    if get("device"):
        argv += ["--device", get("device")]
    if stage == "trajectory":
        argv += ["--filename", get("trajectory")]
        for key in ("world", "model_real"):
            if get(key):
                argv += [f"--{key}", get(key)]
    elif stage == "simulator":
        argv += ["--trajectory", get("trajectory"), "--filename", get("measurements")]
    elif stage == "identifier":
        argv += ["--measurements", get("measurements"), "--trajectory", get("trajectory")]
        for key in ("model_output", "model_real", "validation"):
            if get(key):
                argv += [f"--{key}", get(key)]
    elif stage == "visualizer":
        # the interactive WebGL viewer of the measurements (or trajectory) file
        argv += ["--trajectory", get("measurements") or get("trajectory"), "--webgl"]
        if get("world"):
            argv += ["--world", get("world")]
    else:
        raise ValueError(f"unknown stage {stage!r}")
    return argv


class PipelineGUI:
    FIELDS = [
        ("config", "Config YAML"),
        ("model", "Robot URDF"),
        ("world", "World URDF (optional)"),
        ("model_real", "Ground-truth URDF (optional)"),
        ("validation", "Validation npz (optional)"),
        ("trajectory", "Trajectory npz"),
        ("measurements", "Measurements npz"),
        ("model_output", "Identified URDF out"),
        ("device", "Device (cuda, cpu; empty: cuda)"),
    ]

    def __init__(self):
        import tkinter as tk
        from tkinter import filedialog, scrolledtext

        self.tk = tk
        self.filedialog = filedialog
        self.root = tk.Tk()
        self.root.title("flobaroid_tpu_torch pipeline")
        self.vars = {}
        state = {}
        if os.path.exists(STATE_FILE):
            try:
                state = json.load(open(STATE_FILE))
            except (OSError, json.JSONDecodeError):
                state = {}
        for r, (key, label) in enumerate(self.FIELDS):
            tk.Label(self.root, text=label).grid(row=r, column=0, sticky="w", padx=4)
            var = tk.StringVar(value=state.get(key, ""))
            self.vars[key] = var
            tk.Entry(self.root, textvariable=var, width=60).grid(row=r, column=1, padx=4)
            tk.Button(
                self.root, text="...", command=lambda k=key: self._pick(k)
            ).grid(row=r, column=2)
        row = len(self.FIELDS)
        btns = [
            ("Optimize trajectory", self.run_trajectory),
            ("Simulate", self.run_simulate),
            ("Identify", self.run_identify),
            ("Visualize 3D", self.run_visualize),
            ("Full pipeline", self.run_all),
            ("Cancel", self.cancel),
        ]
        for c, (label, cmd) in enumerate(btns):
            tk.Button(self.root, text=label, command=cmd).grid(row=row, column=0 if c == 0 else 1, sticky="w" if c else "e", pady=6)
        self.out = scrolledtext.ScrolledText(self.root, width=100, height=28, font=("monospace", 9))
        self.out.grid(row=row + 1, column=0, columnspan=3, padx=4, pady=4)
        # stdin passthrough: typed text + Enter goes to the running
        # stage (interactive prompts, reference gui.py:123-152)
        tk.Label(self.root, text="stdin >").grid(row=row + 2, column=0, sticky="w", padx=4)
        self.stdin_var = tk.StringVar()
        stdin_entry = tk.Entry(self.root, textvariable=self.stdin_var, width=60)
        stdin_entry.grid(row=row + 2, column=1, sticky="w", padx=4, pady=2)
        stdin_entry.bind("<Return>", lambda _e: self.send_stdin())
        tk.Button(self.root, text="Send", command=self.send_stdin).grid(row=row + 2, column=2)
        self.proc = None
        self.q: queue.Queue = queue.Queue()
        self.root.after(100, self._drain)
        self.root.protocol("WM_DELETE_WINDOW", self._close)

    # ------------------------------------------------------------------
    def _pick(self, key):
        fn = self.filedialog.askopenfilename()
        if fn:
            self.vars[key].set(fn)

    def _save_state(self):
        json.dump({k: v.get() for k, v in self.vars.items()}, open(STATE_FILE, "w"))

    def _log(self, text):
        self.out.insert("end", ANSI_RE.sub("", text))
        self.out.see("end")

    def _run(self, argv, then=None):
        if self.proc is not None:
            self._log("\n[another stage is running]\n")
            return
        self._save_state()
        argv = sleep_inhibit_prefix() + argv
        self._log(f"\n$ {' '.join(argv)}\n")

        def worker():
            self.proc = subprocess.Popen(
                argv, stdin=subprocess.PIPE, stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True
            )
            for line in self.proc.stdout:
                self.q.put(line)
            rc = self.proc.wait()
            self.q.put(f"[exit {rc}]\n")
            self.proc = None
            if rc == 0 and then:
                self.q.put(("__then__", then))

        threading.Thread(target=worker, daemon=True).start()

    def _drain(self):
        try:
            while True:
                item = self.q.get_nowait()
                if isinstance(item, tuple) and item[0] == "__then__":
                    item[1]()
                else:
                    self._log(item)
        except queue.Empty:
            pass
        self.root.after(100, self._drain)

    def _fields(self) -> dict:
        return {k: v.get() for k, v in self.vars.items()}

    # ------------------------------------------------------------------
    def run_trajectory(self, then=None):
        self._run(stage_argv("trajectory", self._fields()), then)

    def run_simulate(self, then=None):
        self._run(stage_argv("simulator", self._fields()), then)

    def run_identify(self, then=None):
        self._run(stage_argv("identifier", self._fields()), then)

    def run_visualize(self, then=None):
        """Interactive WebGL viewer of the trajectory/measurements file."""
        self._run(stage_argv("visualizer", self._fields()), then)

    def run_all(self):
        self.run_trajectory(then=lambda: self.run_simulate(then=self.run_identify))

    def send_stdin(self):
        """Forward the stdin entry's text (+ newline) to the running
        stage (reference gui.py:123-152)."""
        p = self.proc
        text = self.stdin_var.get()
        if p is None or p.stdin is None:
            self._log("\n[no stage running to receive stdin]\n")
            return
        try:
            p.stdin.write(text + "\n")
            p.stdin.flush()
            self._log(f"> {text}\n")
            self.stdin_var.set("")
        except (BrokenPipeError, OSError):
            self._log("\n[stage stdin closed]\n")

    def cancel(self):
        if self.proc is not None:
            self.proc.terminate()
            self._log("\n[cancelled]\n")

    def _close(self):
        self.cancel()
        self._save_state()
        self.root.destroy()

    def mainloop(self):
        self.root.mainloop()


def main(argv=None):
    try:
        gui = PipelineGUI()
    except Exception as e:  # no display etc.
        print(f"cannot start GUI ({e}); use the flobaroid_tpu_torch.cli commands instead")
        sys.exit(1)
    gui.mainloop()


if __name__ == "__main__":
    main()
