/* SVG chart components following the dataviz mark specs:
   bars ≤24px with 4px rounded data-end (square baseline), 2px lines,
   hairline solid gridlines one step off-surface, ≥8px markers with 2px
   surface ring, per-mark hover tooltips (bars/cells) and a crosshair
   tooltip on lines. Labels/values wear text tokens, never series color. */

import { el, fmtNum, t } from "./app.js";

const NS = "http://www.w3.org/2000/svg";

function svgEl(tag, attrs = {}) {
  const node = document.createElementNS(NS, tag);
  for (const [k, v] of Object.entries(attrs)) node.setAttribute(k, v);
  return node;
}


// Interactive mark helper: pointer + keyboard activation (charts must be
// drillable without a mouse — Enter/Space trigger the same handler).
function makeClickable(node, handler) {
  node.style.cursor = "pointer";
  node.setAttribute("tabindex", "0");
  node.setAttribute("role", "button");
  node.addEventListener("click", handler);
  node.addEventListener("keydown", (ev) => {
    if (ev.key === "Enter" || ev.key === " ") { ev.preventDefault(); handler(ev); }
  });
}

function niceTicks(max, n = 4) {
  if (max <= 0) return [0, 1];
  const step = Math.pow(10, Math.floor(Math.log10(max / n)));
  const err = max / n / step;
  const mult = err >= 7.5 ? 10 : err >= 3.5 ? 5 : err >= 1.5 ? 2 : 1;
  const s = step * mult;
  const ticks = [];
  for (let v = 0; v <= max + s * 0.001; v += s) ticks.push(v);
  return ticks;
}

function chartFrame(width, height, pad) {
  const svg = svgEl("svg", {
    viewBox: `0 0 ${width} ${height}`,
    role: "img", preserveAspectRatio: "xMidYMid meet",
  });
  const wrap = el("div", { class: "chart" });
  const tip = el("div", { class: "tooltip" });
  wrap.append(svg, tip);
  return { wrap, svg, tip, plotW: width - pad.l - pad.r,
           plotH: height - pad.t - pad.b };
}

function showTip(wrap, tip, x, y, rows) {
  tip.replaceChildren(...rows.map(([lbl, val]) => el("div", {},
    el("span", { class: "val" }, val), " ",
    el("span", { class: "lbl" }, lbl))));
  tip.style.display = "block";
  const r = wrap.getBoundingClientRect();
  const tw = tip.offsetWidth, th = tip.offsetHeight;
  let px = x - r.left + 12, py = y - r.top - th - 8;
  if (px + tw > r.width) px = x - r.left - tw - 12;
  if (py < 0) py = y - r.top + 12;
  tip.style.left = px + "px";
  tip.style.top = py + "px";
}

function grid(svg, pad, plotW, plotH, ticks, max, fmt = fmtNum) {
  for (const v of ticks) {
    const y = pad.t + plotH - (v / max) * plotH;
    svg.append(svgEl("line", {
      x1: pad.l, x2: pad.l + plotW, y1: y, y2: y,
      stroke: "var(--border)", "stroke-width": 1 }));
    const lbl = svgEl("text", {
      x: pad.l - 6, y: y + 3.5, "text-anchor": "end",
      "font-size": 10.5, fill: "var(--text-muted)" });
    lbl.textContent = fmt(v);
    svg.append(lbl);
  }
}

/** Vertical bar chart: data = [{label, value}]. Sequential single-hue. */
export function barChart(data, { height = 180, color = "var(--seq-400)",
                                 xLabelEvery = 1, fmt = fmtNum,
                                 onClick = null } = {}) {
  const pad = { l: 42, r: 8, t: 8, b: 22 };
  const width = 640;
  const { wrap, svg, tip, plotW, plotH } = chartFrame(width, height, pad);
  if (!data.length) { wrap.append(el("div", { class: "empty" }, "No data")); return wrap; }
  const max = Math.max(...data.map((d) => d.value), 1);
  const ticks = niceTicks(max);
  grid(svg, pad, plotW, plotH, ticks, ticks[ticks.length - 1], fmt);
  const band = plotW / data.length;
  const bw = Math.min(24, band - 2);             // ≤24px, 2px surface gap
  data.forEach((d, i) => {
    const h = Math.max(0, (d.value / ticks[ticks.length - 1]) * plotH);
    const x = pad.l + i * band + (band - bw) / 2;
    const y = pad.t + plotH - h;
    const r = Math.min(4, bw / 2, h);            // rounded data-end only
    const path = svgEl("path", {
      d: `M${x},${pad.t + plotH} V${y + r} Q${x},${y} ${x + r},${y}`
        + ` H${x + bw - r} Q${x + bw},${y} ${x + bw},${y + r}`
        + ` V${pad.t + plotH} Z`,
      fill: color });
    // hit target wider than the mark
    const hit = svgEl("rect", {
      x: pad.l + i * band, y: pad.t, width: band, height: plotH,
      fill: "transparent" });
    hit.addEventListener("pointermove", (ev) => {
      path.setAttribute("opacity", "0.8");
      showTip(wrap, tip, ev.clientX, ev.clientY,
              [[d.label, fmt(d.value)]]);
    });
    hit.addEventListener("pointerleave", () => {
      path.removeAttribute("opacity");
      tip.style.display = "none";
    });
    if (onClick) makeClickable(hit, () => onClick(d));
    svg.append(path, hit);
    if (i % xLabelEvery === 0) {
      const lbl = svgEl("text", {
        x: x + bw / 2, y: height - 7, "text-anchor": "middle",
        "font-size": 10.5, fill: "var(--text-muted)" });
      lbl.textContent = d.label;
      svg.append(lbl);
    }
  });
  return wrap;
}

/** Horizontal bars for ranked categories: data = [{label, value}].
    onClick(datum) makes rows interactive (species drill-down). */
export function hBarChart(data, { color = "var(--seq-400)",
                                  fmt = fmtNum, onClick = null } = {}) {
  const rowH = 26, pad = { l: 150, r: 52, t: 4, b: 4 };
  const width = 640, height = pad.t + pad.b + data.length * rowH;
  const { wrap, svg, tip } = chartFrame(width, height, pad);
  if (!data.length) { wrap.append(el("div", { class: "empty" }, "No data")); return wrap; }
  const plotW = width - pad.l - pad.r;
  const max = Math.max(...data.map((d) => d.value), 1);
  data.forEach((d, i) => {
    const w = Math.max(2, (d.value / max) * plotW);
    const y = pad.t + i * rowH + (rowH - 16) / 2;
    const r = Math.min(4, w);
    const bar = svgEl("path", {
      d: `M${pad.l},${y} H${pad.l + w - r} Q${pad.l + w},${y} `
        + `${pad.l + w},${y + r > y + 8 ? y + 8 : y + 4}`
        + ` V${y + 16 - 4} Q${pad.l + w},${y + 16} ${pad.l + w - r},${y + 16}`
        + ` H${pad.l} Z`,
      fill: color });
    const name = svgEl("text", {
      x: pad.l - 8, y: y + 12, "text-anchor": "end", "font-size": 11.5,
      fill: "var(--text-secondary)" });
    name.textContent = d.label.length > 22 ? d.label.slice(0, 21) + "…" : d.label;
    const val = svgEl("text", {
      x: pad.l + w + 6, y: y + 12, "font-size": 11,
      fill: "var(--text-primary)", "font-weight": 600 });
    val.textContent = fmt(d.value);
    const hit = svgEl("rect", { x: 0, y: pad.t + i * rowH, width, height: rowH,
                                fill: "transparent" });
    hit.addEventListener("pointermove", (ev) =>
      showTip(wrap, tip, ev.clientX, ev.clientY, [[d.label, fmt(d.value)]]));
    hit.addEventListener("pointerleave", () => tip.style.display = "none");
    if (onClick) makeClickable(hit, () => onClick(d));
    svg.append(bar, name, val, hit);
  });
  return wrap;
}

/** Line chart with crosshair tooltip, click-to-toggle legend, and
    drag-to-zoom x brush (double-click or the reset chip restores the
    full domain). series = [{name, color, points: [{x label, y}]}] —
    all series share x positions. */
export function lineChart(series, { height = 200, fmt = fmtNum } = {}) {
  const hidden = new Set();
  let dom = null;                       // [i0, i1] zoomed index range
  const box = el("div");
  const controls = el("div", { class: "legend" });
  const container = el("div", {}, box, controls);

  function rebuildControls() {
    controls.replaceChildren();
    if (series.length >= 2) {
      for (const s of series) {
        const item = el("span", { tabindex: "0", role: "button",
                                  "aria-pressed": String(!hidden.has(s.name)),
                                  style: "cursor:pointer"
                                    + (hidden.has(s.name)
                                       ? ";opacity:.35" : "") },
          el("span", { class: "key", style: `background:${s.color}` }),
          s.name);
        const toggle = () => {
          if (hidden.has(s.name)) hidden.delete(s.name);
          else if (hidden.size < series.length - 1) hidden.add(s.name);
          draw();
        };
        item.addEventListener("click", toggle);
        item.addEventListener("keydown", (ev) => {
          if (ev.key === "Enter" || ev.key === " ") { ev.preventDefault(); toggle(); }
        });
        controls.append(item);
      }
    }
    if (dom) {
      const reset = el("button", { class: "small" }, t("reset_zoom"));
      reset.addEventListener("click", () => { dom = null; draw(); });
      controls.append(reset);
    }
  }

  function draw() {
    box.replaceChildren();
    const vis = series.filter((s) => !hidden.has(s.name));
    const base = dom ? [dom[0], dom[1]] : null;
    const sliced = vis.map((s) => ({ ...s,
      points: base ? s.points.slice(base[0], base[1] + 1) : s.points }));
    box.append(drawPlot(sliced, (a, b) => {
      const off = base ? base[0] : 0;
      dom = [off + a, off + b];
      draw();
    }, () => { if (dom) { dom = null; draw(); } }));
    rebuildControls();
  }

  function drawPlot(vis, onBrush, onResetGesture) {
    const pad = { l: 42, r: 10, t: 10, b: 22 };
    const width = 640;
    const { wrap, svg, tip, plotW, plotH } = chartFrame(width, height, pad);
    const n = vis[0]?.points.length || 0;
    if (!n) { wrap.append(el("div", { class: "empty" }, "No data")); return wrap; }
    const max = Math.max(...vis.flatMap((s) => s.points.map((p) => p.y)), 1);
    const ticks = niceTicks(max);
    const top = ticks[ticks.length - 1];
    grid(svg, pad, plotW, plotH, ticks, top, fmt);
    const xAt = (i) => pad.l + (n === 1 ? plotW / 2 : (i / (n - 1)) * plotW);
    const yAt = (v) => pad.t + plotH - (v / top) * plotH;
    for (const s of vis) {
      const dAttr = s.points.map((p, i) =>
        `${i === 0 ? "M" : "L"}${xAt(i).toFixed(1)},${yAt(p.y).toFixed(1)}`).join(" ");
      if (s.area) {
        svg.append(svgEl("path", {
          d: `${dAttr} L${xAt(n - 1)},${pad.t + plotH} L${xAt(0)},${pad.t + plotH} Z`,
          fill: s.color, opacity: 0.1 }));
      }
      svg.append(svgEl("path", {
        d: dAttr, fill: "none", stroke: s.color, "stroke-width": 2,
        "stroke-linejoin": "round", "stroke-linecap": "round" }));
      // end marker: ≥8px with 2px surface ring
      const last = s.points[n - 1];
      svg.append(svgEl("circle", { cx: xAt(n - 1), cy: yAt(last.y), r: 6,
                                   fill: "var(--surface-1)" }));
      svg.append(svgEl("circle", { cx: xAt(n - 1), cy: yAt(last.y), r: 4,
                                   fill: s.color }));
    }
    // x labels (sparse)
    const every = Math.ceil(n / 8);
    vis[0].points.forEach((p, i) => {
      if (i % every !== 0 && i !== n - 1) return;
      const lbl = svgEl("text", { x: xAt(i), y: height - 7,
        "text-anchor": "middle", "font-size": 10.5, fill: "var(--text-muted)" });
      lbl.textContent = p.x;
      svg.append(lbl);
    });
    // crosshair + one tooltip for every series at the snapped X
    const cross = svgEl("line", { y1: pad.t, y2: pad.t + plotH,
      stroke: "var(--text-muted)", "stroke-width": 1, visibility: "hidden" });
    svg.append(cross);
    const sel = svgEl("rect", { y: pad.t, height: plotH,
      fill: "var(--seq-400)", opacity: 0.15, visibility: "hidden" });
    svg.append(sel);
    const hit = svgEl("rect", { x: pad.l, y: pad.t, width: plotW, height: plotH,
                                fill: "transparent" });
    const fxOf = (ev) => {
      const boxr = svg.getBoundingClientRect();
      return (ev.clientX - boxr.left) * (width / boxr.width);
    };
    const idxOf = (fx) => Math.max(0, Math.min(n - 1,
      Math.round((fx - pad.l) / (plotW / Math.max(1, n - 1)))));
    let brush0 = null;            // [fx, index] at pointerdown
    hit.addEventListener("pointerdown", (ev) => {
      brush0 = [fxOf(ev), idxOf(fxOf(ev))];
      hit.setPointerCapture(ev.pointerId);
    });
    hit.addEventListener("pointerup", (ev) => {
      if (!brush0) return;
      const [fx0, i0] = brush0;
      brush0 = null;
      sel.setAttribute("visibility", "hidden");
      const fx1 = fxOf(ev);
      const i1 = idxOf(fx1);
      // a real drag (not a click) spanning ≥2 points zooms
      if (Math.abs(fx1 - fx0) > 8 && Math.abs(i1 - i0) >= 1 && n > 2) {
        onBrush(Math.min(i0, i1), Math.max(i0, i1));
      }
    });
    hit.addEventListener("dblclick", onResetGesture);
    hit.addEventListener("pointermove", (ev) => {
      const fx = fxOf(ev);
      if (brush0) {
        sel.setAttribute("x", Math.min(brush0[0], fx));
        sel.setAttribute("width", Math.abs(fx - brush0[0]));
        sel.setAttribute("visibility", "visible");
        return;
      }
      const i = idxOf(fx);
      cross.setAttribute("x1", xAt(i));
      cross.setAttribute("x2", xAt(i));
      cross.setAttribute("visibility", "visible");
      showTip(wrap, tip, ev.clientX, ev.clientY,
              [[vis[0].points[i].x, ""]].concat(
                vis.map((s) => [s.name, fmt(s.points[i].y)])));
    });
    hit.addEventListener("pointerleave", () => {
      cross.setAttribute("visibility", "hidden");
      tip.style.display = "none";
    });
    svg.append(hit);
    return wrap;
  }

  draw();
  return container;
}

/** Heatmap grid: rows × cols with sequential fill.
    data = {rows: [label], cols: [label], values: [[v]]}. */
export function heatmap(data, { fmt = fmtNum, onCellClick = null } = {}) {
  const cell = 17, gap = 2;
  const pad = { l: 78, t: 4, r: 4, b: 20 };
  const width = pad.l + data.cols.length * (cell + gap) + pad.r;
  const height = pad.t + data.rows.length * (cell + gap) + pad.b;
  const { wrap, svg, tip } = chartFrame(width, height, pad);
  const max = Math.max(...data.values.flat(), 1);
  const ramp = ["var(--seq-150)", "var(--seq-250)", "var(--seq-400)",
                "var(--seq-550)", "var(--seq-700)"];
  data.rows.forEach((rl, ri) => {
    const name = svgEl("text", { x: pad.l - 6, y: pad.t + ri * (cell + gap) + cell - 4,
      "text-anchor": "end", "font-size": 10.5, fill: "var(--text-secondary)" });
    name.textContent = rl.length > 12 ? rl.slice(0, 11) + "…" : rl;
    svg.append(name);
    data.cols.forEach((cl, ci) => {
      const v = data.values[ri][ci] || 0;
      const idx = v === 0 ? -1
        : Math.min(ramp.length - 1, Math.floor((v / max) * ramp.length));
      const rect = svgEl("rect", {
        x: pad.l + ci * (cell + gap), y: pad.t + ri * (cell + gap),
        width: cell, height: cell, rx: 3,
        fill: idx < 0 ? "var(--surface-2)" : ramp[idx] });
      rect.addEventListener("pointermove", (ev) =>
        showTip(wrap, tip, ev.clientX, ev.clientY, [[`${rl} · ${cl}`, fmt(v)]]));
      rect.addEventListener("pointerleave", () => tip.style.display = "none");
      if (onCellClick) makeClickable(rect, () => onCellClick(rl, cl, v));
      svg.append(rect);
    });
  });
  data.cols.forEach((cl, ci) => {
    if (ci % Math.ceil(data.cols.length / 12) !== 0) return;
    const lbl = svgEl("text", { x: pad.l + ci * (cell + gap) + cell / 2,
      y: height - 6, "text-anchor": "middle", "font-size": 10,
      fill: "var(--text-muted)" });
    lbl.textContent = cl;
    svg.append(lbl);
  });
  return wrap;
}

/** Ridgeline: per-category activity profiles sharing an x axis, each row
    normalized to its own peak (reference SpeciesRidgeline.svelte).
    rows = [{label, values: number[]}], all values arrays equal length. */
export function ridgeline(rows, { colLabels = null, fmt = fmtNum } = {}) {
  const rowH = 30, curveH = 44;                  // curves overlap upward
  const pad = { l: 150, r: 12, t: curveH - rowH + 6, b: 20 };
  const width = 640;
  const height = pad.t + rows.length * rowH + pad.b;
  const { wrap, svg, tip } = chartFrame(width, height, pad);
  if (!rows.length) { wrap.append(el("div", { class: "empty" }, "No data")); return wrap; }
  const plotW = width - pad.l - pad.r;
  const n = rows[0].values.length;
  const xAt = (i) => pad.l + (i / Math.max(1, n - 1)) * plotW;
  rows.forEach((row, ri) => {
    const base = pad.t + (ri + 1) * rowH - 6;
    const peak = Math.max(...row.values, 1);
    const yAt = (v) => base - (v / peak) * curveH;
    const line = row.values.map((v, i) =>
      `${i === 0 ? "M" : "L"}${xAt(i).toFixed(1)},${yAt(v).toFixed(1)}`).join(" ");
    svg.append(svgEl("path", {
      d: `${line} L${xAt(n - 1)},${base} L${xAt(0)},${base} Z`,
      fill: "var(--seq-250)", opacity: 0.55 }));
    svg.append(svgEl("path", {
      d: line, fill: "none", stroke: "var(--seq-550)", "stroke-width": 1.5,
      "stroke-linejoin": "round" }));
    const name = svgEl("text", {
      x: pad.l - 8, y: base, "text-anchor": "end", "font-size": 11.5,
      fill: "var(--text-secondary)" });
    name.textContent = row.label.length > 22
      ? row.label.slice(0, 21) + "…" : row.label;
    const hit = svgEl("rect", {
      x: pad.l, y: base - rowH + 4, width: plotW, height: rowH,
      fill: "transparent" });
    hit.addEventListener("pointermove", (ev) => {
      const box = svg.getBoundingClientRect();
      const fx = (ev.clientX - box.left) * (width / box.width);
      const i = Math.max(0, Math.min(n - 1,
        Math.round((fx - pad.l) / (plotW / Math.max(1, n - 1)))));
      const cl = colLabels ? colLabels[i] : String(i);
      showTip(wrap, tip, ev.clientX, ev.clientY,
              [[`${row.label} · ${cl}`, fmt(row.values[i])]]);
    });
    hit.addEventListener("pointerleave", () => tip.style.display = "none");
    svg.append(name, hit);
  });
  if (colLabels) {
    colLabels.forEach((cl, i) => {
      if (i % Math.ceil(n / 9) !== 0) return;
      const lbl = svgEl("text", { x: xAt(i), y: height - 6,
        "text-anchor": "middle", "font-size": 10, fill: "var(--text-muted)" });
      lbl.textContent = cl;
      svg.append(lbl);
    });
  }
  return wrap;
}

/** 24-hour radial activity clock, midnight at top, night arc shaded
    (reference NocturnalClock.svelte). hourly = number[24]. */
export function radialClock(hourly, { size = 260, night = [20, 6],
                                      fmt = fmtNum } = {}) {
  const cx = size / 2, cy = size / 2;
  const rIn = size * 0.17, rOut = size * 0.44;
  const { wrap, svg, tip } = chartFrame(size, size, { l: 0, r: 0, t: 0, b: 0 });
  const max = Math.max(...hourly, 1);
  const angle = (h) => (h / 24) * 2 * Math.PI - Math.PI / 2;  // 0h at top
  const pt = (a, r) => [cx + r * Math.cos(a), cy + r * Math.sin(a)];
  const sector = (h, r0, r1) => {
    const a0 = angle(h) + 0.02, a1 = angle(h + 1) - 0.02;
    const [x0, y0] = pt(a0, r0), [x1, y1] = pt(a0, r1);
    const [x2, y2] = pt(a1, r1), [x3, y3] = pt(a1, r0);
    return `M${x0},${y0} L${x1},${y1} A${r1},${r1} 0 0 1 ${x2},${y2}`
      + ` L${x3},${y3} A${r0},${r0} 0 0 0 ${x0},${y0} Z`;
  };
  const isNight = (h) => night[0] > night[1]
    ? (h >= night[0] || h < night[1]) : (h >= night[0] && h < night[1]);
  for (let h = 0; h < 24; h++) {
    if (isNight(h)) svg.append(svgEl("path", {
      d: sector(h, rIn - 3, rOut + 5), fill: "var(--surface-2)" }));
  }
  const ramp = ["var(--seq-150)", "var(--seq-250)", "var(--seq-400)",
                "var(--seq-550)", "var(--seq-700)"];
  for (let h = 0; h < 24; h++) {
    const v = hourly[h] || 0;
    const r1 = rIn + (v / max) * (rOut - rIn);
    const idx = v === 0 ? 0
      : Math.min(ramp.length - 1, Math.floor((v / max) * ramp.length));
    const bar = svgEl("path", {
      d: sector(h, rIn, Math.max(rIn + 2, r1)),
      fill: v === 0 ? "var(--surface-2)" : ramp[idx] });
    bar.addEventListener("pointermove", (ev) =>
      showTip(wrap, tip, ev.clientX, ev.clientY,
              [[`${String(h).padStart(2, "0")}:00`, fmt(v)]]));
    bar.addEventListener("pointerleave", () => tip.style.display = "none");
    svg.append(bar);
  }
  for (const h of [0, 6, 12, 18]) {
    const [x, y] = pt(angle(h), rOut + 14);
    const lbl = svgEl("text", { x, y: y + 3, "text-anchor": "middle",
      "font-size": 10.5, fill: "var(--text-muted)" });
    lbl.textContent = `${h}h`;
    svg.append(lbl);
  }
  return wrap;
}

/** 12-point sparkline for stat tiles (de-emphasis hue). */
export function sparkline(values, { width = 110, height = 30 } = {}) {
  const svg = svgEl("svg", { viewBox: `0 0 ${width} ${height}`,
                             style: `width:${width}px;height:${height}px` });
  if (!values.length) return svg;
  const max = Math.max(...values, 1);
  const pts = values.map((v, i) =>
    `${(i / Math.max(1, values.length - 1)) * (width - 6) + 3},`
    + `${height - 3 - (v / max) * (height - 8)}`);
  svg.append(svgEl("path", { d: "M" + pts.join(" L"), fill: "none",
    stroke: "var(--seq-250)", "stroke-width": 2, "stroke-linecap": "round" }));
  const [lx, ly] = pts[pts.length - 1].split(",");
  svg.append(svgEl("circle", { cx: lx, cy: ly, r: 3, fill: "var(--seq-400)" }));
  return svg;
}

/** Catmull-Rom → cubic-bezier smoothing for band boundaries (the
    curveBasis look without d3). pts = [[x, y], …] → full path string. */
function smoothPath(pts) {
  let d = `M${pts[0][0].toFixed(1)},${pts[0][1].toFixed(1)}`;
  for (let i = 0; i < pts.length - 1; i++) {
    const p0 = pts[Math.max(0, i - 1)], p1 = pts[i];
    const p2 = pts[i + 1], p3 = pts[Math.min(pts.length - 1, i + 2)];
    d += ` C${(p1[0] + (p2[0] - p0[0]) / 6).toFixed(1)},`
      + `${(p1[1] + (p2[1] - p0[1]) / 6).toFixed(1)} `
      + `${(p2[0] - (p3[0] - p1[0]) / 6).toFixed(1)},`
      + `${(p2[1] - (p3[1] - p1[1]) / 6).toFixed(1)} `
      + `${p2[0].toFixed(1)},${p2[1].toFixed(1)}`;
    }
  return d;
}

/** Streamgraph: one smoothed band per category over shared buckets,
    stacked inside-out around a centered (silhouette) baseline — the
    reference's acoustic-succession diel chart
    (frontend/.../charts/d3/AcousticSuccessionChart.svelte: stacked
    per-species hour-of-day bands, stackOffsetWiggle + stackOrderInsideOut,
    no y-axis, inline label at each band's thickest column when ≥13px,
    hover tooltip, persistent swatch legend). rows = [{label, values}]. */
export function streamGraph(rows, { colLabels = null, fmt = fmtNum,
                                    height = 230 } = {}) {
  const pad = { l: 10, r: 10, t: 10, b: 22 };
  const width = 640;
  const { wrap, svg, tip, plotW, plotH } = chartFrame(width, height, pad);
  if (!rows.length || !rows[0].values.length) {
    wrap.append(el("div", { class: "empty" }, "No data"));
    return wrap;
  }
  const n = rows[0].values.length;
  // inside-out order: largest totals in the middle, alternating sides
  const order = [];
  rows.map((r, i) => [r.values.reduce((s, v) => s + (v || 0), 0), i])
    .sort((a, b) => b[0] - a[0])
    .forEach((pair, k) => {
      if (k % 2) order.push(pair[1]); else order.unshift(pair[1]);
    });
  // silhouette offset: every column's stack is centered on zero
  const totals = Array.from({ length: n }, (_, j) =>
    rows.reduce((s, r) => s + (r.values[j] || 0), 0));
  const maxTotal = Math.max(...totals, 1);
  let acc = totals.map((tot) => -tot / 2);
  const layers = order.map((i) => {
    const y0 = acc;
    acc = acc.map((v, j) => v + (rows[i].values[j] || 0));
    return { row: rows[i], series: i, y0, y1: acc };
  });
  const xAt = (j) => pad.l + (j / Math.max(1, n - 1)) * plotW;
  const yAt = (v) => pad.t + plotH / 2 - (v / maxTotal) * plotH;
  const colorOf = (i) => `var(--series-${(i % 5) + 1})`;
  const labels = [];
  for (const L of layers) {
    const top = L.y1.map((v, j) => [xAt(j), yAt(v)]);
    const bot = L.y0.map((v, j) => [xAt(j), yAt(v)]).reverse();
    const band = svgEl("path", {
      d: smoothPath(top) + ` L${bot[0][0].toFixed(1)},${bot[0][1].toFixed(1)} `
        + smoothPath(bot).slice(1) + " Z",
      fill: colorOf(L.series), opacity: 0.85 });
    band.addEventListener("pointermove", (ev) => {
      band.setAttribute("opacity", "1");
      const box = svg.getBoundingClientRect();
      const fx = (ev.clientX - box.left) * (width / box.width);
      const j = Math.max(0, Math.min(n - 1,
        Math.round((fx - pad.l) / (plotW / Math.max(1, n - 1)))));
      const cl = colLabels ? colLabels[j] : String(j);
      showTip(wrap, tip, ev.clientX, ev.clientY,
              [[`${L.row.label} · ${cl}`, fmt(L.row.values[j] || 0)]]);
    });
    band.addEventListener("pointerleave", () => {
      band.setAttribute("opacity", "0.85");
      tip.style.display = "none";
    });
    svg.append(band);
    // inline label at the band's thickest column, only when it fits
    let jPeak = 0, thick = 0;
    for (let j = 0; j < n; j++) {
      const h = yAt(L.y0[j]) - yAt(L.y1[j]);
      if (h > thick) { thick = h; jPeak = j; }
    }
    if (thick >= 13) {
      const lbl = svgEl("text", {
        x: xAt(jPeak), y: (yAt(L.y0[jPeak]) + yAt(L.y1[jPeak])) / 2 + 3.5,
        "text-anchor": "middle", "font-size": 10.5, "font-weight": 600,
        fill: "var(--text-primary)", "pointer-events": "none" });
      lbl.textContent = L.row.label.length > 20
        ? L.row.label.slice(0, 19) + "…" : L.row.label;
      labels.push(lbl);
    }
  }
  svg.append(...labels);                     // labels above every band
  if (colLabels) {
    colLabels.forEach((cl, j) => {
      if (j % 3 !== 0) return;               // every 3rd hour, as reference
      const lbl = svgEl("text", { x: xAt(j), y: height - 6,
        "text-anchor": "middle", "font-size": 10, fill: "var(--text-muted)" });
      lbl.textContent = cl;
      svg.append(lbl);
    });
  }
  // persistent legend: a streamgraph has no y-axis to anchor names to
  const legend = el("div", { class: "legend" }, rows.map((r, i) =>
    el("span", {}, el("span", { class: "key",
                               style: `background:${colorOf(i)}` }), r.label)));
  return el("div", {}, wrap, legend);
}

/** First-heard timeline: one row per species with a marker at its first
    detection date on a shared time axis (reference
    frontend/.../charts/d3/NewSpeciesTimelineChart.svelte: band scale per
    species, time x-scale, tooltip, species label per row).
    items = [{label, date: "YYYY-MM-DD", sci}], onClick(item) drills. */
export function timelineChart(items, { from = null, to = null,
                                       onClick = null } = {}) {
  const rowH = 24, pad = { l: 150, r: 18, t: 8, b: 24 };
  const width = 640, height = pad.t + items.length * rowH + pad.b;
  const { wrap, svg, tip } = chartFrame(width, height, pad);
  if (!items.length) {
    wrap.append(el("div", { class: "empty" }, "No data"));
    return wrap;
  }
  const plotW = width - pad.l - pad.r;
  const ms = (d) => new Date(d + "T00:00:00Z").getTime();
  const dates = items.map((it) => ms(it.date));
  const t0 = from ? ms(from) : Math.min(...dates);
  const t1 = to ? ms(to) : Math.max(...dates);
  const span = Math.max(1, t1 - t0);
  const xAt = (d) => pad.l + ((ms(d) - t0) / span) * plotW;
  // ~6 date ticks across the span
  const nTicks = Math.min(6, Math.max(2, Math.round(plotW / 90)));
  for (let k = 0; k <= nTicks; k++) {
    const tms = t0 + (span * k) / nTicks;
    const x = pad.l + (plotW * k) / nTicks;
    svg.append(svgEl("line", { x1: x, x2: x, y1: pad.t,
      y2: height - pad.b, stroke: "var(--border)", "stroke-width": 1 }));
    const lbl = svgEl("text", { x, y: height - 7, "text-anchor": "middle",
      "font-size": 10, fill: "var(--text-muted)" });
    lbl.textContent = new Date(tms).toISOString().slice(5, 10);
    svg.append(lbl);
  }
  items.forEach((it, i) => {
    const cy = pad.t + i * rowH + rowH / 2;
    const cx = xAt(it.date);
    const name = svgEl("text", { x: pad.l - 8, y: cy + 3.5,
      "text-anchor": "end", "font-size": 11.5,
      fill: "var(--text-secondary)" });
    name.textContent = it.label.length > 22
      ? it.label.slice(0, 21) + "…" : it.label;
    const guide = svgEl("line", { x1: pad.l, x2: cx, y1: cy, y2: cy,
      stroke: "var(--border)", "stroke-width": 1,
      "stroke-dasharray": "2,3" });
    // ≥8px marker with a 2px surface ring (mark spec)
    const ring = svgEl("circle", { cx, cy, r: 6, fill: "var(--surface-1)" });
    const dot = svgEl("circle", { cx, cy, r: 4,
      fill: `var(--series-${(i % 5) + 1})` });
    const hit = svgEl("rect", { x: 0, y: pad.t + i * rowH, width,
      height: rowH, fill: "transparent" });
    hit.addEventListener("pointermove", (ev) =>
      showTip(wrap, tip, ev.clientX, ev.clientY, [[it.label, it.date]]));
    hit.addEventListener("pointerleave", () => tip.style.display = "none");
    if (onClick) makeClickable(hit, () => onClick(it));
    svg.append(guide, name, ring, dot, hit);
  });
  return wrap;
}
