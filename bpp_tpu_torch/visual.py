"""Species-tree PDF export (the reference's visual.c + pdfgen.c).

The reference bundles a from-scratch single-file PDF generator
(src/pdfgen.c) and draws the species tree with a time grid after an
A00 run (``stree_export_pdf`` visual.c:1218, called from
method.c:6528).  This module is the same idea re-done small: a minimal
PDF 1.4 writer (uncompressed content streams, base-14 fonts, correct
xref table — everything a viewer needs, nothing more) and a
tree/network plotter.

Layout mirrors the reference plot: time runs right-to-left (root
deepest at the left), tips evenly spaced vertically at the right
margin, rectangular branches, a dotted time grid labelled with tau
values (``plot_tree_with_grid`` visual.c), tip names after the tips,
and for MSC-I networks the extra mirror-node edges (visual.c:1204).

A host copy of ``bpp_tpu/visual.py`` (numpy); its page is byte for byte
``bpp_tpu``'s but for the time stamp and the command line.
"""

from __future__ import annotations

import time as _time

import numpy as np

_PAGE_W, _PAGE_H = 595.0, 842.0   # A4 portrait like pdfgen defaults
_MARGIN = 50.0


class MiniPdf:
    """Minimal one-page PDF document builder."""

    def __init__(self, width: float = _PAGE_W, height: float = _PAGE_H,
                 title: str = "Binary species tree"):
        self.width = width
        self.height = height
        self.title = title
        self._ops: list[str] = []

    # --- drawing ops (user space = PDF points, origin bottom-left) -------

    def line(self, x1, y1, x2, y2, width=1.0, rgb=(0, 0, 0), dash=None):
        d = f"[{dash:g}] 0 d" if dash else "[] 0 d"
        self._ops.append(
            f"q {rgb[0]:g} {rgb[1]:g} {rgb[2]:g} RG {width:g} w {d} "
            f"{x1:.2f} {y1:.2f} m {x2:.2f} {y2:.2f} l S Q")

    def text(self, s: str, x, y, size=10.0, rgb=(0, 0, 0), font="F1"):
        esc = s.replace("\\", r"\\").replace("(", r"\(").replace(")", r"\)")
        self._ops.append(
            f"q BT /{font} {size:g} Tf {rgb[0]:g} {rgb[1]:g} {rgb[2]:g} rg "
            f"{x:.2f} {y:.2f} Td ({esc}) Tj ET Q")

    def circle(self, x, y, r, rgb=(0, 0, 0)):
        # four-arc Bezier approximation
        k = 0.5523 * r
        self._ops.append(
            f"q {rgb[0]:g} {rgb[1]:g} {rgb[2]:g} rg "
            f"{x + r:.2f} {y:.2f} m "
            f"{x + r:.2f} {y + k:.2f} {x + k:.2f} {y + r:.2f} "
            f"{x:.2f} {y + r:.2f} c "
            f"{x - k:.2f} {y + r:.2f} {x - r:.2f} {y + k:.2f} "
            f"{x - r:.2f} {y:.2f} c "
            f"{x - r:.2f} {y - k:.2f} {x - k:.2f} {y - r:.2f} "
            f"{x:.2f} {y - r:.2f} c "
            f"{x + k:.2f} {y - r:.2f} {x + r:.2f} {y - k:.2f} "
            f"{x + r:.2f} {y:.2f} c f Q")

    # --- serialization ----------------------------------------------------

    def tobytes(self) -> bytes:
        stream = ("\n".join(self._ops)).encode("latin-1", "replace")
        objs: list[bytes] = []
        objs.append(b"<< /Type /Catalog /Pages 2 0 R >>")
        objs.append(b"<< /Type /Pages /Kids [3 0 R] /Count 1 >>")
        objs.append((
            f"<< /Type /Page /Parent 2 0 R "
            f"/MediaBox [0 0 {self.width:g} {self.height:g}] "
            f"/Resources << /Font << /F1 5 0 R /F2 6 0 R >> >> "
            f"/Contents 4 0 R >>").encode())
        objs.append(b"<< /Length %d >>\nstream\n%s\nendstream"
                    % (len(stream), stream))
        objs.append(b"<< /Type /Font /Subtype /Type1 "
                    b"/BaseFont /Helvetica >>")
        objs.append(b"<< /Type /Font /Subtype /Type1 "
                    b"/BaseFont /Courier-Bold >>")
        info = (f"<< /Title ({self.title}) /Creator (bpp_tpu) "
                f"/Producer (bpp_tpu) >>").encode()
        objs.append(info)

        out = bytearray(b"%PDF-1.4\n%\xe2\xe3\xcf\xd3\n")
        offsets = [0]
        for i, body in enumerate(objs, start=1):
            offsets.append(len(out))
            out += b"%d 0 obj\n" % i
            out += body
            out += b"\nendobj\n"
        xref_at = len(out)
        n = len(objs) + 1
        out += b"xref\n0 %d\n" % n
        out += b"0000000000 65535 f \n"
        for off in offsets[1:]:
            out += b"%010d 00000 n \n" % off
        out += (b"trailer\n<< /Size %d /Root 1 0 R /Info %d 0 R >>\n"
                b"startxref\n%d\n%%%%EOF\n" % (n, len(objs), xref_at))
        return bytes(out)

    def save(self, path: str):
        with open(path, "wb") as fh:
            fh.write(self.tobytes())


def _layout(st, tau):
    """(x, y) page coordinates per node: x from tau, y from tip order."""
    H = st.n_nodes
    NS = st.n_tips
    x = np.zeros(H)
    y = np.zeros(H)
    tau_max = float(max(tau.max(), 1e-12))
    x_tip = _PAGE_W - _MARGIN - 60.0
    x_root = _MARGIN + 20.0
    span = x_tip - x_root

    def xpos(t):
        return x_tip - span * (t / tau_max)

    # tips spaced evenly top->bottom in index order
    y_top = _PAGE_H - _MARGIN - 40.0
    y_bot = _MARGIN + 40.0
    for i in range(NS):
        y[i] = y_top - (y_top - y_bot) * (i / max(NS - 1, 1))
        x[i] = xpos(float(tau[i]))
    # inner nodes postorder: y = midpoint of children
    for i in st.postorder_inner():
        li, ri = int(st.left[i]), int(st.right[i])
        ys = [y[li]] + ([y[ri]] if ri >= 0 else [])
        y[i] = float(np.mean(ys))
        x[i] = xpos(float(tau[i]))
    # mirror nodes sit at their own tau on the path to their parent
    if st.hybrid is not None:
        for i in range(H):
            if st.is_mirror(i):
                partner = int(st.hybrid[i])
                x[i] = xpos(float(tau[i]))
                y[i] = y[partner] - 12.0
    return x, y, xpos, tau_max


def stree_export_pdf(st, path: str, tau=None, theta=None,
                     cmdline: str = "", grid: int = 3):
    """Draw the species tree/network with a time grid into ``path``.

    ``tau``/``theta`` default to the tree's own values (posterior means
    are what the A00 summary passes in, matching visual.c usage)."""
    tau = np.asarray(st.tau if tau is None else tau, float)
    theta_a = None if theta is None else np.asarray(theta, float)
    pdf = MiniPdf()
    H, NS = st.n_nodes, st.n_tips
    x, y, xpos, tau_max = _layout(st, tau)

    # time grid (plot_tree_with_grid): dotted verticals at tau fractions
    for g in range(grid + 1):
        t = tau_max * g / grid
        gx = xpos(t)
        pdf.line(gx, _MARGIN + 25, gx, _PAGE_H - _MARGIN - 25,
                 width=0.4, rgb=(0.6, 0.6, 0.6), dash=2.0)
        pdf.text(f"{t:.4g}", gx - 10, _MARGIN + 12, size=8, font="F2")
    pdf.text("tau", _PAGE_W - _MARGIN - 30, _MARGIN + 12, size=8, font="F2")

    def draw_edge(child: int, parent: int):
        # rectangular: horizontal from child x to parent x at child's y,
        # then vertical to parent's y
        pdf.line(x[child], y[child], x[parent], y[child], width=1.2)
        pdf.line(x[parent], y[child], x[parent], y[parent], width=1.2)

    for i in range(H):
        p = int(st.parent[i])
        if p < 0:
            continue
        if st.hybrid is not None and st.is_mirror(i):
            # mirror-node edge (visual.c:1204): connect to partner too
            partner = int(st.hybrid[i])
            pdf.line(x[partner], y[partner], x[i], y[i],
                     width=1.0, rgb=(0.8, 0.2, 0.2), dash=3.0)
            draw_edge(i, p)
            continue
        draw_edge(i, p)

    for i in range(H):
        pdf.circle(x[i], y[i], 1.6)
        if i < NS:
            pdf.text(st.names[i], x[i] + 6, y[i] - 3, size=10)
        else:
            pdf.text(str(i + 1), x[i] + (-13 if st.parent[i] < 0 else 5),
                     y[i] - 9, size=7, rgb=(0.8, 0, 0))
        if theta_a is not None and np.isfinite(theta_a[i]) \
                and theta_a[i] > 0:
            pdf.text(f"{theta_a[i]:.4g}", x[i] + 6, y[i] + 6, size=6,
                     rgb=(0, 0, 0.8))
        if st.phi is not None and st.hybrid is not None \
                and int(st.hybrid[i]) >= 0 and not st.is_mirror(i):
            pdf.text(f"phi={float(st.phi[i]):.3g}", x[i] + 6, y[i] - 18,
                     size=6, rgb=(0.8, 0.2, 0.2))

    stamp = _time.strftime("%c")
    pdf.text(stamp, 5, 5, size=8, font="F2")
    if cmdline:
        pdf.text(cmdline, 120, 5, size=8, font="F2")
    pdf.text("Created with: bpp_tpu", 5, _PAGE_H - 15, size=8, font="F2")
    pdf.save(path)
    return path
