// Client DOM wiring mirroring the Leptos app (client/src/app.rs, header.rs,
// image_card.rs, image_modal.rs) against the same HTTP contract. The pure
// behavior lives in logic.js (window.ISXLogic) and is CI-tested headlessly
// (tests/test_client_logic.py); this file only binds it to the DOM.

const L = window.ISXLogic;

const state = {
  results: [],          // [{id, image_path, score}]
  marked: [],           // image_path strings submitted as referenced_images
  view: "search",       // "search" | "dups" (duplicate-groups layout)
  groups: [],           // duplicate groups when view === "dups"
};

const $ = (id) => document.getElementById(id);
const grid = $("grid");
const statusEl = $("status");

function setStatus(msg) { statusEl.textContent = msg; }

// --- search (app.rs:26-56, header.rs:13-20) --------------------------------

async function performSearch() {
  const q = $("search-input").value.trim();
  if (!q) return; // non-empty guard (header.rs:14)
  setStatus("searching…");
  try {
    const res = await fetch("/search", {
      method: "POST",
      headers: { "content-type": "application/json" },
      body: L.searchBody(q, state.marked),
    });
    if (!res.ok) throw new Error(`HTTP ${res.status}`);
    const data = await res.json();
    state.view = "search";
    state.results = L.resultsOf(data);
    // marks persist across rounds (reference: marked_images RwSignal is
    // never cleared, app.rs:24) — feedback accumulates until un-checked
    render();
    setStatus(`${state.results.length} results`);
  } catch (err) {
    setStatus(`search failed: ${err.message}`);
  }
}

// --- query-by-image (POST /search_image; beyond the reference) --------------

async function performImageSearch(file) {
  if (!file) return;
  setStatus("searching by image…");
  try {
    // marks ride as ?ref= params (raw-bytes body): a feedback round
    // refines the image query exactly like a text one
    const res = await fetch(L.imageSearchUrl(state.marked), { method: "POST", body: file });
    if (!res.ok) throw new Error(`HTTP ${res.status}`);
    const data = await res.json();
    state.view = "search";
    state.results = L.resultsOf(data);
    render();
    setStatus(`${state.results.length} results (image query)`);
  } catch (err) {
    setStatus(`image search failed: ${err.message}`);
  }
}

// --- scan (app.rs:59-69) ----------------------------------------------------

async function performScan() {
  const btn = $("scan-btn");
  btn.disabled = true;
  setStatus("scanning… (embeds every new image; may take a while)");
  try {
    const res = await fetch("/scan");
    if (!res.ok) throw new Error(`HTTP ${res.status}`);
    const stats = await res.json().catch(() => null);
    setStatus(L.scanStatusText(stats));
  } catch (err) {
    setStatus(`scan failed: ${err.message}`);
  } finally {
    btn.disabled = false;
  }
}

// --- delete marked (POST /remove; beyond the reference) ---------------------

async function performRemove() {
  // only VISIBLE marks are deleted — feedback marks from earlier rounds
  // that aren't on screen stay untouched (and stay marked)
  const toDelete = L.visibleMarked(state.marked, state.results);
  if (!toDelete.length) { setStatus("mark visible images first"); return; }
  if (!window.confirm(`Delete ${toDelete.length} marked image(s) from the index?`)) return;
  setStatus("removing…");
  try {
    const res = await fetch("/remove", {
      method: "POST",
      headers: { "content-type": "application/json" },
      body: L.removeBody(toDelete),
    });
    if (!res.ok) throw new Error(`HTTP ${res.status}`);
    const resp = await res.json();
    state.marked = state.marked.filter((p) => !toDelete.includes(p));
    if (state.view === "dups") {
      // stay in the duplicates layout: surviving groups keep their borders
      state.groups = L.groupsAfterRemoval(state.groups, toDelete);
      renderGroups(state.groups);
    } else {
      state.results = L.afterRemoval(state.results, toDelete);
      render();
    }
    setStatus(L.removedStatusText(resp));
  } catch (err) {
    setStatus(`remove failed: ${err.message}`);
  }
}

// --- duplicates view (GET /duplicates; beyond the reference) -----------------

async function performDuplicates() {
  setStatus("scanning for duplicates…");
  try {
    const res = await fetch("/duplicates?threshold=0.97");
    if (!res.ok) throw new Error(`HTTP ${res.status}`);
    state.view = "dups";
    state.groups = L.duplicateGroupsOf(await res.json());
    renderGroups(state.groups);
    setStatus(L.dupStatusText(state.groups));
  } catch (err) {
    setStatus(`duplicates failed: ${err.message}`);
  }
}

function renderGroups(groups) {
  // each group renders as a bordered row of normal cards: mark the copies
  // you don't want, then "Delete marked"
  state.results = [];
  grid.replaceChildren(...groups.map((group) => {
    const box = document.createElement("div");
    box.className = "dup-group";
    group.forEach((path) => {
      const img = { id: encodeURIComponent(path), image_path: path, score: 1 };
      state.results.push(img);
      box.append(makeCard(img));
    });
    return box;
  }));
}

// --- grid + cards (image_grid.rs, image_card.rs) -----------------------------

function makeCard(img) {
  const card = document.createElement("div");
  card.className = "card";
  card.dataset.id = img.id;

  // mark checkbox = relevance-feedback selection (image_card.rs:12-27)
  const mark = document.createElement("input");
  mark.type = "checkbox";
  mark.className = "mark";
  mark.checked = state.marked.includes(img.image_path);
  mark.addEventListener("change", () => {
    state.marked = L.toggleMark(state.marked, img.image_path, mark.checked);
    card.classList.toggle("marked", mark.checked);
  });

  const pic = document.createElement("img");
  pic.loading = "lazy";
  pic.src = img.image_path; // relative media/... URL (image_card.rs:52-62)
  pic.alt = img.image_path;
  pic.addEventListener("click", () => openModal(img.image_path));

  if (mark.checked) card.classList.add("marked");  // persists across rounds
  card.append(mark, pic);
  return card;
}

function render() {
  grid.replaceChildren(...state.results.map(makeCard));
}

// --- zoom/pan modal (image_modal.rs) -----------------------------------------

const modal = $("modal");
const modalImg = $("modal-img");
let zoom = 1, panX = 0, panY = 0, dragging = false, lastX = 0, lastY = 0;

function applyTransform() {
  modalImg.style.transform = L.transformOf(zoom, panX, panY);
}

function openModal(src) {
  zoom = 1; panX = 0; panY = 0;
  modalImg.src = src;
  applyTransform();
  modal.classList.remove("hidden");
}

function closeModal() { modal.classList.add("hidden"); }

// wheel-zoom about the cursor, clamped to [0.5, 5] (image_modal.rs:14-34)
modal.addEventListener("wheel", (e) => {
  e.preventDefault();
  const rect = modalImg.getBoundingClientRect();
  const cx = e.clientX - (rect.left + rect.width / 2);
  const cy = e.clientY - (rect.top + rect.height / 2);
  const next = L.wheelZoom(zoom, panX, panY, e.deltaY, cx, cy);
  zoom = next.zoom; panX = next.panX; panY = next.panY;
  applyTransform();
}, { passive: false });

// mouse-drag panning (image_modal.rs:36-55)
modal.addEventListener("mousedown", (e) => {
  if (e.target !== modalImg) return;
  dragging = true; lastX = e.clientX; lastY = e.clientY;
  modal.style.cursor = "grabbing";
  e.preventDefault();
});
window.addEventListener("mousemove", (e) => {
  if (!dragging) return;
  const next = L.panMove(panX, panY, lastX, lastY, e.clientX, e.clientY);
  panX = next.panX; panY = next.panY; lastX = next.lastX; lastY = next.lastY;
  applyTransform();
});
window.addEventListener("mouseup", () => {
  dragging = false;
  modal.style.cursor = "grab";
});

// click outside the image closes (image_modal.rs:68)
modal.addEventListener("click", (e) => {
  if (L.shouldCloseModal(e.target === modal, "")) closeModal();
});
window.addEventListener("keydown", (e) => {
  if (L.shouldCloseModal(false, e.key)) closeModal();
});

// --- wiring -------------------------------------------------------------------

$("search-input").addEventListener("keydown", (e) => {
  if (L.shouldSearch(e.key, $("search-input").value)) performSearch();
});
$("scan-btn").addEventListener("click", performScan);
$("dup-btn").addEventListener("click", performDuplicates);
$("remove-btn").addEventListener("click", performRemove);
$("img-btn").addEventListener("click", () => $("image-input").click());
$("image-input").addEventListener("change", () => {
  performImageSearch(L.pickedQueryFile($("image-input").files));
  $("image-input").value = "";
});
// drop a photo anywhere to search by it
window.addEventListener("dragover", (e) => e.preventDefault());
window.addEventListener("drop", (e) => {
  e.preventDefault();
  const f = L.pickedQueryFile(e.dataTransfer && e.dataTransfer.files);
  if (f) performImageSearch(f);
});
