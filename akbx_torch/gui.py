"""KB design GUI: a tkinter front-end over :mod:`akbx_torch.design` (port
of :mod:`akbx.gui`; the reference's design tool).

Parameter entry fields (l_i1, na_o_sin_v, na_o_sin_h, target_gap, ast,
l_o1, theta_g1, target_l_o2) with the reference's defaults, a compute
button that runs the KB design, the layout and incident-angle figures
embedded through ``FigureCanvasTkAgg``, and a scrolled results pane.

:func:`compute_design` and :func:`make_figures` run headless; every
tkinter import is inside :func:`main`.  Run with

    python -m akbx_torch.gui [--device cpu]
"""

from __future__ import annotations

import argparse

FIELDS = [
    ("l_i1", "48.6"),
    ("na_o_sin_v", "0.002"),
    ("na_o_sin_h", "0.002"),
    ("target_gap", "0.1"),
    ("ast", "0."),
    ("l_o1", "0.33"),
    ("theta_g1", "0.006"),
    ("target_l_o2", "0.04"),
]


def compute_design(values: dict, device=None):
    """Run the KB design for a dict of field values on ``device`` (default
    the card).  Returns (ell1, ell2, summary_text)."""
    from akbx_torch import design, plotting

    e1 = design.design_ell_v(values["l_i1"], values["l_o1"],
                             values["theta_g1"], values["na_o_sin_v"],
                             device=device)
    e1, e2 = design.design_ell_h(e1, values["target_l_o2"],
                                 values["target_gap"], values["ast"],
                                 values["na_o_sin_h"])
    return e1, e2, plotting.design_summary_text(e1, e2)


def make_figures(e1, e2):
    """The two GUI figures (layout, incident angles)."""
    from akbx_torch import plotting

    return [plotting.ellipse_layout(e1, e2),
            plotting.incident_angles(e1, e2)]


def main(device=None):  # pragma: no cover - requires a display
    import tkinter as tk
    from tkinter import ttk
    from tkinter.scrolledtext import ScrolledText

    from matplotlib.backends.backend_tkagg import FigureCanvasTkAgg

    root = tk.Tk()
    root.title("KB design tool (akbx_torch)")

    frame = ttk.Frame(root, padding=10)
    frame.grid(row=0, column=0)

    entries = {}
    for i, (label, default) in enumerate(FIELDS):
        ttk.Label(frame, text=label).grid(row=i, column=0, sticky=tk.W,
                                          pady=2)
        entry = ttk.Entry(frame)
        entry.insert(0, default)
        entry.grid(row=i, column=1, pady=2)
        entries[label] = entry

    canvas_frame1 = ttk.LabelFrame(root, text="Layout")
    canvas_frame1.grid(row=0, column=1, padx=10, pady=5)
    canvas_frame2 = ttk.LabelFrame(root, text="Incident angles")
    canvas_frame2.grid(row=1, column=1, padx=10, pady=5)
    text_output = ScrolledText(root, width=60, height=20)
    text_output.grid(row=2, column=0, columnspan=2, padx=10, pady=10)

    def run():
        try:
            values = {k: float(v.get()) for k, v in entries.items()}
            e1, e2, summary = compute_design(values, device=device)
            text_output.delete(1.0, tk.END)
            text_output.insert(tk.END, summary)
            for frame_, fig in zip((canvas_frame1, canvas_frame2),
                                   make_figures(e1, e2)):
                for widget in frame_.winfo_children():
                    widget.destroy()
                canvas = FigureCanvasTkAgg(fig, master=frame_)
                canvas.draw()
                canvas.get_tk_widget().pack()
        except Exception as exc:  # the pane shows the error, as the ref does
            text_output.delete(1.0, tk.END)
            text_output.insert(tk.END, f"Error: {exc}")

    ttk.Button(frame, text="Compute", command=run).grid(
        row=len(FIELDS), column=0, columnspan=2, pady=5)

    root.mainloop()


if __name__ == "__main__":  # pragma: no cover
    parser = argparse.ArgumentParser(prog="akbx_torch.gui")
    parser.add_argument("--device", default="cuda")
    main(parser.parse_args().device)
